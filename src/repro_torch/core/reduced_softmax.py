"""The paper's contribution: the Reduced Softmax unit.

Counterpart of the single-device part of ``repro.core.reduced_softmax``.
Theorem 1 (exp, hence softmax, is monotonic) means an inference-only
accelerator can replace the softmax activation by a comparator:
``predict(x) = argmax(x)`` with NO exponentials, sum or division, and the
classification is identical.

  1. ``reduced_softmax_predict``  the pure form (argmax);
  2. ``fused_reduced_head``       argmax over ``h @ W`` without storing the
                                  logits (the CUDA head kernel on the
                                  card, its plain version on the CPU);
  3. ``reduced_topk`` /           the k-winner comparator, plain and fused
     ``fused_reduced_topk``       with the head matmul.

  4. ``topk_sample``              the keyed draw over the k survivors
                                  (``prng.categorical``: a softmax over k
                                  values, not the vocabulary).

Ties everywhere: the lowest index wins (as ``torch.argmax``).
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.kernels import ops, ref


def reduced_softmax_predict(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The comparator unit: class = argmax of the raw inputs -- by
    Theorem 1 equal to ``argmax(softmax(x))``."""
    return torch.argmax(x, dim=dim)


def argmax_with_value(x: torch.Tensor, dim: int = -1):
    """(argmax, max) pair -- the comparator's full output bus."""
    return torch.argmax(x, dim=dim), torch.amax(x, dim=dim)


def reduced_topk(x: torch.Tensor, k: int):
    """The k-winner comparator: top-k (vals f32, idxs int32) over the
    last axis, values descending, the lowest index first among ties.
    Still zero exp / sum / divide; for k = 1 it is
    ``reduced_softmax_predict`` plus the max value."""
    return ref.topk_select(x, k)


def topk_sample(vals: torch.Tensor, idxs: torch.Tensor, key: torch.Tensor,
                temperature: float = 1.0) -> torch.Tensor:
    """Sample a vocabulary id from the k comparator survivors: vals /
    idxs (B, k) from ``reduced_topk`` or the fused head, ONE key (2,)
    over the (B, k) logits, as ``repro.core.reduced_softmax.topk_sample``
    draws.  The softmax this stands for runs over k values, not V;
    temperature <= 0 is greedy (survivor 0).  Returns (B,) int32."""
    if temperature <= 0.0:
        return idxs[:, 0].to(torch.int32)
    choice = prng.categorical(key, vals.float() / temperature)      # (B,)
    return torch.gather(idxs, 1, choice[:, None])[:, 0].to(torch.int32)


def fused_reduced_topk(h: torch.Tensor, w: torch.Tensor, k: int):
    """Top-k of ``h @ w`` over the vocabulary without storing the logits:
    (vals (B, k) f32, idxs (B, k) int32) -- the bus a top-k sampler
    reads."""
    return ops.fused_topk_head(h, w, k)


def fused_reduced_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary of ``h @ w`` for greedy decoding: (B,)
    int32, h (B, D), w (D, V)."""
    return ops.fused_argmax_head(h, w)


def unit_op_counts(k: int, precision_bits: int = 8, cordic_iters: int = 24):
    """Arithmetic-op inventory of each softmax unit for one k-class
    decision (a copy of the JAX package's table): exp/LUT lookups, adds,
    multiplies/divides, compares -- the paper's circuit-size argument in
    op counts."""
    return {
        "softmax": dict(exp=k, add=k - 1, div=k, cmp=k - 1, lut=0),
        "log_softmax": dict(exp=k, add=2 * k - 1, div=0, cmp=2 * (k - 1),
                            lut=0),
        "base2_softmax": dict(exp=0, add=2 * k - 1, div=k, cmp=k - 1, lut=k,
                              shift=k),
        "pseudo_softmax": dict(exp=0, add=k - 1, div=k, cmp=k - 1, lut=k),
        "inverse_softmax": dict(exp=k, add=k, div=0, cmp=k - 1,
                                cordic_iters=cordic_iters * k),
        "reduced (ours)": dict(exp=0, add=0, div=0, cmp=k - 1, lut=0),
    }
