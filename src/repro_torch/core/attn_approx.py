"""The approximate-attention score-function catalog.

Counterpart of ``repro.core.attn_approx``.  The paper's reduced unit
fires at the LM head, once per token; the attention softmax recurs per
layer per token, which is where the related work attacks it with
exp-free datapaths.  This module is the one place the port defines those
score functions: the plain paged attention (``kernels/ref.py``), the
CUDA kernel's ROMs (``kernels/paged_attention.py``), the engine and the
divergence probe (``repro_torch/probe.py``) all read it.

``exact``    the online softmax (e^x, exact rescale), the baseline.
``base2``    e^x as 2^(x*log2e): integer part a shift, fractional part a
             2^P-entry LUT (``core.softmax_variants.base2_exp_raw``).
``pseudo``   pseudo-softmax, base 2 outright: 2^x / sum 2^x.
``pwl``      piecewise-linear exp: exact 2^n shift + chord interpolation
             of 2^v over ``PWL_SEGMENTS`` uniform segments.
``maxonly``  winner-take-all: the V row of the single highest-scoring
             key (ties -> lowest position); no exp, sum or divide.

Weights are defined against the global max M of the masked scores,
``w_i = f(s_i - M) / sum_j f(s_j - M)``; the kernel evaluates ``f`` at
its running max and rescales the carry with ``carry_scale`` (exact, in
the variant's base), so the approximation stays single-shot per score.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.softmax_variants import LOG2E, base2_exp_raw

# scores at or below this are masked (the plain version masks at -1e30;
# the LUT-based f's are not defined at -inf)
MASK_FLOOR = -1e29

# chord count of the pwl variant (a 17-entry endpoint ROM)
PWL_SEGMENTS = 16

BASE2_PRECISION_BITS = 8


@dataclasses.dataclass(frozen=True)
class AttnScore:
    """One catalog entry: what the score function is and when it's safe."""
    name: str
    description: str
    exp_free: bool           # datapath is shift/LUT/compare only (no e^x)
    order_preserving: bool   # per-score monotone map (top target unchanged)
    softmax_approx: bool     # approximates the exact softmax weights


CATALOG = {
    s.name: s for s in (
        AttnScore("exact", "online softmax (e^x, exact rescale)",
                  exp_free=False, order_preserving=True,
                  softmax_approx=True),
        AttnScore("base2", "e^x via shift + 2^P-entry fractional LUT",
                  exp_free=True, order_preserving=True,
                  softmax_approx=True),
        AttnScore("pseudo", "pseudo-softmax: 2^x / sum 2^x (base 2 "
                            "outright; order-preserving, not softmax)",
                  exp_free=True, order_preserving=True,
                  softmax_approx=False),
        AttnScore("pwl", "piecewise-linear exp: shift + chord-interpolated "
                         "2^v over uniform segments",
                  exp_free=True, order_preserving=True,
                  softmax_approx=True),
        AttnScore("maxonly", "winner-take-all: V row of the max score "
                             "(comparator only)",
                  exp_free=True, order_preserving=True,
                  softmax_approx=False),
    )
}

VARIANTS: Tuple[str, ...] = tuple(CATALOG)


def resolve(name: Optional[str], window: Optional[int] = None
            ) -> Tuple[str, Optional[int]]:
    """Normalize and validate the (attn_approx, attn_window) pair -- the
    one check every surface (ops, engine, params, probe) routes
    through."""
    name = "exact" if name is None else str(name)
    if name not in CATALOG:
        raise ValueError(
            f"attn_approx={name!r}: expected one of {sorted(CATALOG)}")
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(
                f"attn_window={window}: must be >= 1 (the window always "
                "includes the query's own position) or None for full "
                "attention")
    return name, window


# ---------------------------------------------------------------------------
# The score functions: f(d) for d = s - m <= 0, plus the carry rescale
# ---------------------------------------------------------------------------
def pwl_lut(segments: int = PWL_SEGMENTS, device=None) -> torch.Tensor:
    """The (segments+1)-entry endpoint ROM 2^(i/segments), f32 on
    ``device``.  The paged attention kernel's pwl ROM is this tensor."""
    idx = torch.arange(segments + 1, dtype=torch.float32, device=device)
    return torch.exp2(idx / segments)


def pwl_exp2_raw(y: torch.Tensor, segments: int = PWL_SEGMENTS
                 ) -> torch.Tensor:
    """2^y by exact integer shift + piecewise-linear (chord)
    interpolation of the fractional part over ``segments`` uniform
    segments."""
    n = torch.floor(y)
    v = y - n
    lut = pwl_lut(segments, y.device)
    pos = v * segments
    i = torch.clip(torch.floor(pos).to(torch.int32), 0, segments - 1)
    t = pos - i.to(torch.float32)
    lo = lut[i.long()]
    hi = lut[i.long() + 1]
    return torch.exp2(n) * (lo + (hi - lo) * t)


def pwl_exp_raw(x: torch.Tensor, segments: int = PWL_SEGMENTS
                ) -> torch.Tensor:
    """e^x via the PWL 2^y unit (y = x * log2e)."""
    return pwl_exp2_raw(x * LOG2E, segments)


def weight_exp(d: torch.Tensor, name: str) -> torch.Tensor:
    """The variant's per-score numerator f(d), d = s - m <= 0 and finite
    (callers zero masked lanes outside).  Not defined for 'maxonly' (a
    comparator, not a weight)."""
    if name == "exact":
        return torch.exp(d)
    if name == "pseudo":
        return torch.exp2(d)
    if name == "base2":
        return base2_exp_raw(d, precision_bits=BASE2_PRECISION_BITS)
    if name == "pwl":
        return pwl_exp_raw(d)
    raise ValueError(f"attn_approx={name!r} has no weight function "
                     f"(expected one of {sorted(set(CATALOG) - {'maxonly'})})")


def carry_scale(dm: torch.Tensor, name: str) -> torch.Tensor:
    """The online-carry rescale for a running-max bump dm = m_prev -
    m_new <= 0: exact in the variant's base (2^x for pseudo, e^x
    otherwise)."""
    return torch.exp2(dm) if name == "pseudo" else torch.exp(dm)


# ---------------------------------------------------------------------------
# Dense weights (the plain paged attention + the probe's score error)
# ---------------------------------------------------------------------------
def attn_weights(scores: torch.Tensor, name: str,
                 axis: int = -1) -> torch.Tensor:
    """Normalized attention weights over ``axis`` for masked f32 scores
    (masked lanes at -inf or <= MASK_FLOOR): the dense single-shot form
    of the kernel's online carry."""
    if name == "exact":
        return torch.softmax(scores, dim=axis)
    if name == "maxonly":
        ax = axis % scores.dim()
        shape = [1] * scores.dim()
        shape[ax] = scores.shape[ax]
        iota = torch.arange(scores.shape[ax], device=scores.device
                            ).reshape(shape).expand(scores.shape)
        m = torch.amax(scores, dim=ax, keepdim=True)
        hit = scores == m
        first = torch.amin(torch.where(hit, iota, torch.iinfo(
            torch.int64).max), dim=ax, keepdim=True)
        return (iota == first).to(torch.float32)
    live = scores > MASK_FLOOR
    m = torch.amax(scores, dim=axis, keepdim=True)
    d = torch.where(live, scores - m, 0.0)
    e = torch.where(live, weight_exp(d, name), 0.0)
    return e / torch.clamp(torch.sum(e, dim=axis, keepdim=True), min=1e-30)


def score_error(scores: torch.Tensor, name: str,
                axis: int = -1) -> torch.Tensor:
    """Max |w_variant - w_exact| over the whole score tensor -- the
    probe's per-layer weight-error metric."""
    return torch.amax(torch.abs(attn_weights(scores, name, axis)
                                - attn_weights(scores, "exact", axis)))
