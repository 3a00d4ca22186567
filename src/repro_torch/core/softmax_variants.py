"""Hardware softmax-unit baselines the paper compares against.

Counterpart of ``repro.core.softmax_variants``: each "unit" mirrors a
published hardware softmax implementation at the algorithm level, so a
benchmark can compare classification agreement with the exact softmax
and arithmetic cost against the paper's reduced (argmax-only) unit.

- ``softmax_unit``            exact, numerically-stable softmax (the reference).
- ``log_softmax_unit``        Kouretas & Paliouras [2]: the log domain, max
                              subtracted so every exp() input is <= 0.
- ``base2_softmax_unit``      Zhu et al. [3]: e^x = 2^(x*log2 e); the integer
                              part of the exponent is a shift, the fractional
                              part a P-bit LUT (2^P entries, nearest index).
- ``pseudo_softmax_unit``     Cardarilli et al. [4]: 2^x / sum 2^x; not the
                              softmax, but order-preserving.
- ``inverse_softmax_unit``    Kagalkar & Raghuram [5], eq. (3):
                              s'(x_j) = 1 + sum_{i != j} e^{x_i - x_j}; the
                              predicted class is argmin s'.
- ``cordic_exp``              hyperbolic-rotation CORDIC e^x (fixed count).

Rounding follows the JAX package: ``torch.round`` rounds half to even,
as ``jnp.round`` does.  Shapes: ``x`` is ``(..., k)`` with the class
axis last; the functions that build a table take the ``device`` to
build it on.
"""
from __future__ import annotations

import math

import torch

# log2(e), the shared base-2 constant (attn_approx.py and the paged
# attention kernel use it for every e^x = 2^(x*log2e) rewrite)
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# Exact reference
# ---------------------------------------------------------------------------
def softmax_unit(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Numerically-stable exact softmax (eq. (1) of the paper)."""
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp(x - m.detach())
    return e / torch.sum(e, dim=axis, keepdim=True)


def predict_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Classification through the full softmax unit: argmax of s(x)."""
    return torch.argmax(softmax_unit(x, axis=axis), dim=axis)


# ---------------------------------------------------------------------------
# [2] Kouretas & Paliouras: log-domain simplification
# ---------------------------------------------------------------------------
def log_softmax_unit(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """log s(x) with the max-shift so every exp() input is <= 0 (the
    bounded-LUT property of [2])."""
    m = torch.amax(x, dim=axis, keepdim=True)
    z = x - m
    return z - torch.log(torch.sum(torch.exp(z), dim=axis, keepdim=True))


def predict_log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.argmax(log_softmax_unit(x, axis=axis), dim=axis)


# ---------------------------------------------------------------------------
# [3] Zhu et al.: base-2, precision-adjustable (P-bit fractional LUT)
# ---------------------------------------------------------------------------
def base2_frac_lut(precision_bits: int = 8, device=None) -> torch.Tensor:
    """The 2^P-entry fractional LUT a base-2 unit holds in ROM:
    2^(i/size) for i in [0, size), f32 on ``device``.  The paged
    attention kernel's base2 ROM is this tensor."""
    size = 1 << precision_bits
    idx = torch.arange(size, dtype=torch.float32, device=device)
    return torch.exp2(idx / size)


def base2_exp_raw(x: torch.Tensor, precision_bits: int = 8) -> torch.Tensor:
    """e^x as 2^(x*log2e): y = n + v with n = floor(y) (a shift in
    hardware, exact here) and 2^v read from the 2^P-entry LUT at index
    clip(round(v * 2^P), 0, 2^P - 1) -- half to even, and v -> 1 clips
    to the last entry."""
    y = x * LOG2E
    n = torch.floor(y)
    v = y - n
    size = 1 << precision_bits
    lut = base2_frac_lut(precision_bits, x.device)
    idx = torch.clip(torch.round(v * size).to(torch.int32), 0, size - 1)
    return torch.exp2(n) * lut[idx.long()]


def base2_softmax_unit(x: torch.Tensor, precision_bits: int = 8,
                       axis: int = -1) -> torch.Tensor:
    m = torch.amax(x, dim=axis, keepdim=True)
    e = base2_exp_raw(x - m, precision_bits=precision_bits)
    return e / torch.sum(e, dim=axis, keepdim=True)


def predict_base2_softmax(x: torch.Tensor, precision_bits: int = 8,
                          axis: int = -1) -> torch.Tensor:
    return torch.argmax(
        base2_softmax_unit(x, precision_bits=precision_bits, axis=axis),
        dim=axis)


# ---------------------------------------------------------------------------
# [4] Cardarilli et al.: pseudo-softmax (base 2 outright)
# ---------------------------------------------------------------------------
def pseudo_softmax_unit(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """2^x / sum 2^x -- not equal to softmax but order-preserving."""
    m = torch.amax(x, dim=axis, keepdim=True)
    e = torch.exp2(x - m)
    return e / torch.sum(e, dim=axis, keepdim=True)


def predict_pseudo_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.argmax(pseudo_softmax_unit(x, axis=axis), dim=axis)


# ---------------------------------------------------------------------------
# [5] Kagalkar & Raghuram: CORDIC exp + inverse softmax
# ---------------------------------------------------------------------------
def cordic_exp(x: torch.Tensor, iterations: int = 24) -> torch.Tensor:
    """e^x via hyperbolic CORDIC (rotation mode), fixed iteration count.

    Range reduction x = q*ln2 + r (|r| <= ln2/2, inside the CORDIC
    domain), then micro-rotations z -> z -/+ atanh(2^-i) with the
    standard repeats at i = 4 and 13; e^r = cosh r + sinh r, times 2^q.
    """
    ln2 = 0.6931471805599453
    q = torch.round(x / ln2)
    r = x - q * ln2

    sched = []
    i = 1
    while len(sched) < iterations:
        sched.append(i)
        if i in (4, 13):            # repeat for hyperbolic convergence
            sched.append(i)
        i += 1
    sched = sched[:iterations]

    # gain K = prod sqrt(1 - 2^-2i); start at x0 = 1/K, y0 = 0
    k = 1.0
    for i in sched:
        k *= (1.0 - 2.0 ** (-2 * i)) ** 0.5
    cx = torch.full_like(r, 1.0 / k)
    cy = torch.zeros_like(r)
    cz = r
    for i in sched:
        t = 2.0 ** (-i)
        alpha = math.atanh(t)
        d = torch.where(cz >= 0, 1.0, -1.0).to(r.dtype)
        cx, cy, cz = cx + d * t * cy, cy + d * t * cx, cz - d * alpha
    return torch.exp2(q) * (cx + cy)


def inverse_softmax_unit(x: torch.Tensor, axis: int = -1,
                         exp_fn=torch.exp) -> torch.Tensor:
    """Eq. (3) of the paper: s'(x_j) = 1 + sum_{i != j} e^{x_i - x_j},
    the reciprocal of softmax (no divider); ``exp_fn`` is pluggable so
    the CORDIC exp of [5] can be used."""
    m = torch.amax(x, dim=axis, keepdim=True)
    tot = torch.sum(exp_fn(x - m), dim=axis, keepdim=True)
    return tot * exp_fn(m - x)


def predict_inverse_softmax(x: torch.Tensor, axis: int = -1,
                            exp_fn=torch.exp) -> torch.Tensor:
    return torch.argmin(inverse_softmax_unit(x, axis=axis, exp_fn=exp_fn),
                        dim=axis)


PREDICT_FNS = {
    "softmax": predict_softmax,
    "log_softmax": predict_log_softmax,
    "base2_softmax": predict_base2_softmax,
    "pseudo_softmax": predict_pseudo_softmax,
    "inverse_softmax": predict_inverse_softmax,
}
