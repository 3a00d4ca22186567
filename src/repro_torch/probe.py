"""Greedy-divergence probe: how wrong is each approximate score function?

Counterpart of ``repro.probe``.  The approximate-attention catalog
(``core/attn_approx.py``) swaps the paged decode path's softmax for
exp-free datapaths; the kernel checks bound the numeric error, and this
harness measures the error that matters for serving: does the greedy
token stream change, and where?

Two instruments over the same prompt set:

  TOKEN DIVERGENCE -- one engine run per variant, each request's greedy
  stream diffed against the ``exact`` baseline:
    divergence             fraction of requests whose stream differs
    first_divergence       per request: index of the first differing
                           token (None = identical stream)
    mean_first_divergence  over diverged requests
  The exact arm diffs against itself and must report 0.0.

  SCORE ERROR (``score_probe=True``) -- one more exact engine run with
  the ``models.layers._ATTN_TAP`` hook set.  Each paged-attention call's
  masked f32 scores are rebuilt from its operands as the plain version
  builds them, and ``attn_approx.score_error`` reports, per layer, the
  worst |w_variant - w_exact| over every call.  The JAX package keeps
  each call's operands and scores them afterwards; the port's pools are
  written in place and a freed block is handed to the next request, so
  the port scores each call when it happens, on the call's device, and
  keeps only the per-layer running maxima.

Report (JSON-ready; ``ServeEngine.probe_report`` surfaces one in
``snapshot()`` as 'attn_probe')::

  {"window": ..., "n_requests": N, "baseline": "exact",
   "variants": {name: {"divergence": float, "diverged_requests": int,
                       "n_requests": N, "first_divergence": [...],
                       "mean_first_divergence": float|None,
                       "score_error": {"layer_0": float, ...}}},
   "runs": [{"attn_approx": name, "decode_steps": int,
             "prefills": int}, ...]}

``runs`` (not in the JAX report) lists every engine run in order: the
exact baseline, one per non-exact arm, then the score run.

CLI (on the card unless ``--device cpu``)::

  PYTHONPATH=src python -m repro_torch.probe --arch qwen3-0.6b --smoke \\
      --device cpu --requests 6 --max-new 10 [--window 32] \\
      [--variants pseudo maxonly]

exits non-zero if the exact arm diverges from itself.
"""
from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import attn_approx as approx
from repro_torch.models import layers, lm
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.params import SamplingParams


def _serve(params, cfg, prompts, sp: SamplingParams, *,
           attn_approx: str, attn_window: Optional[int],
           runs: Optional[list] = None, **engine_kwargs):
    """One engine run; returns (the per-request generated streams, the
    engine's stats), and appends the run's mode, decode steps and
    prefills to ``runs``."""
    eng = ServeEngine(params, cfg, attn_approx=attn_approx,
                      attn_window=attn_window, **engine_kwargs)
    reqs = [Request(i, np.asarray(p, np.int32).copy(), params=sp)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    if runs is not None:
        runs.append({"attn_approx": attn_approx,
                     "decode_steps": eng.stats["decode_steps"],
                     "prefills": eng.stats["prefills"]})
    return [list(r.generated) for r in reqs], eng.stats


def _divergence(baseline, streams) -> dict:
    """Token-diff metrics of ``streams`` against the exact ``baseline``."""
    first = []
    for ref, got in zip(baseline, streams):
        pos = next((i for i, (a, b)
                    in enumerate(zip(ref, got)) if a != b), None)
        if pos is None and len(ref) != len(got):
            pos = min(len(ref), len(got))
        first.append(pos)
    diverged = [p for p in first if p is not None]
    return {
        "divergence": len(diverged) / max(len(first), 1),
        "diverged_requests": len(diverged),
        "n_requests": len(first),
        "first_divergence": first,
        "mean_first_divergence": (float(np.mean(diverged))
                                  if diverged else None),
    }


def _masked_scores(q, ck, cv, block_tables, cpm, window):
    """The (B, T, Hq, S) masked f32 score tensor of one paged-attention
    call, as the plain version builds it (GQA by repeat: the weights
    depend only on the scores)."""
    del cv
    if q.dim() == 3:
        q = q[:, None]
        cpm = cpm.reshape(-1, 1)
    b, t, hq, hd = q.shape
    hkv = ck.shape[2]
    k = ck[block_tables.long()].reshape(b, -1, hkv, hd)
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
    scores = torch.einsum("bthd,bshd->bths", q.float(),
                          k.float()) / (hd ** 0.5)
    pos = cpm.long().reshape(b, t)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = kv_pos[None, None, :] <= pos[:, :, None]
    if window is not None:
        mask &= kv_pos[None, None, :] > pos[:, :, None] - window
    return torch.where(mask[:, :, None, :], scores, -1e30)


class _ScoreTap:
    """The ``layers._ATTN_TAP`` of a score run: scores each call as it
    is made and folds its error per variant into the running maximum of
    its layer (device tensors, read once at the end)."""

    def __init__(self, variants: Sequence[str], window: Optional[int],
                 n_attn: int):
        self.variants, self.window, self.n_attn = variants, window, n_attn
        self.calls = 0
        self.worst = {v: {} for v in variants}

    def append(self, operands) -> None:
        scores = _masked_scores(*operands, self.window)
        layer = f"layer_{self.calls % self.n_attn}"
        self.calls += 1
        for v in self.variants:
            err = approx.score_error(scores, v)
            prev = self.worst[v].get(layer)
            self.worst[v][layer] = err if prev is None \
                else torch.maximum(prev, err)

    def report(self) -> dict:
        return {v: {layer: float(e) for layer, e in per.items()}
                for v, per in self.worst.items()}


def layer_score_errors(params, cfg, prompts, sp: SamplingParams, *,
                       variants: Sequence[str],
                       window: Optional[int],
                       runs: Optional[list] = None,
                       **engine_kwargs) -> dict:
    """Per-layer worst-case |w_variant - w_exact| over an exact engine
    run, each paged-attention call scored through the
    ``layers._ATTN_TAP`` hook as it is made.  One run scores every
    variant: the weights are recomputed from the same score matrices.
    The run is appended to ``runs`` as ``_serve`` does."""
    n_attn = sum(count for unit, count in lm.segments(cfg)
                 for kind in unit if kind == "attn") or 1
    tap = _ScoreTap(list(variants), window, n_attn)
    layers._ATTN_TAP = tap
    try:
        _serve(params, cfg, prompts, sp, attn_approx="exact",
               attn_window=window, runs=runs, **engine_kwargs)
    finally:
        layers._ATTN_TAP = None
    return tap.report()


def run_probe(params, cfg, prompts, *,
              variants: Sequence[str] = approx.VARIANTS,
              window: Optional[int] = None,
              max_new_tokens: int = 16,
              score_probe: bool = True,
              sampling: Optional[SamplingParams] = None,
              **engine_kwargs) -> dict:
    """Serve ``prompts`` once per variant and report greedy divergence
    against the exact baseline (plus per-layer score error when
    ``score_probe``).  ``engine_kwargs`` pass through to ``ServeEngine``
    (``kv_layout='dense'`` has no paged path, nor has a windowed config
    such as the hybrid family's recurrentgemma or an attention-free one
    such as rwkv6, so its first approximate arm, or any ``window``,
    raises ``ValueError``, as the reference's engine does); ``window`` applies to every arm, the baseline
    included, so the report isolates the score function's effect at that
    window."""
    variants = list(variants)
    if "exact" not in variants:
        variants = ["exact"] + variants
    sp = sampling if sampling is not None \
        else SamplingParams(max_new_tokens=max_new_tokens)
    runs = []
    baseline, _ = _serve(params, cfg, prompts, sp, attn_approx="exact",
                         attn_window=window, runs=runs, **engine_kwargs)
    report = {"window": window, "n_requests": len(prompts),
              "baseline": "exact", "variants": {}, "runs": runs}
    for v in variants:
        streams = baseline if v == "exact" else _serve(
            params, cfg, prompts, sp, attn_approx=v,
            attn_window=window, runs=runs, **engine_kwargs)[0]
        report["variants"][v] = _divergence(baseline, streams)
    if score_probe:
        score_vars = [v for v in variants if v != "exact"]
        if score_vars:
            errs = layer_score_errors(params, cfg, prompts, sp,
                                      variants=score_vars, window=window,
                                      runs=runs, **engine_kwargs)
            for v, per_layer in errs.items():
                report["variants"][v]["score_error"] = per_layer
    return report


def main(argv=None) -> int:
    import argparse

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.weights import seeded_params

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels, the default) or 'cpu' (the "
                         "plain versions)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--variants", nargs="*", default=list(approx.VARIANTS))
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--no-score-probe", dest="score_probe",
                    action="store_false", default=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the probe runs on the card "
                         "(pass --device cpu for the plain versions)")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    params = seeded_params(cfg, args.seed, device)
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(4, 24))).astype(np.int32)
               for _ in range(args.requests)]
    report = run_probe(params, cfg, prompts, variants=args.variants,
                       window=args.window, max_new_tokens=args.max_new,
                       score_probe=args.score_probe,
                       n_slots=args.slots, max_len=args.max_len)
    print(json.dumps(report, indent=2))
    exact = report["variants"]["exact"]
    if exact["divergence"] != 0.0:
        print("FAIL: exact arm diverged from itself -- the engine-level "
              "bit-identity contract is broken")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
