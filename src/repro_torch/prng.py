"""Keyed, counter-based random numbers: the threefry-2x32 generator and
the draws the serving engine's keyed sampling makes, in torch integer
and float ops.

Counterpart of the parts of ``jax.random`` that ``repro``'s keyed
sampling calls (``PRNGKey``, ``fold_in``, ``split``, ``uniform``,
``gumbel``, ``categorical``), written from jax 0.9's threefry in its
partitionable mode (``jax_threefry_partitionable``, the default there)
with 64-bit types off, so that the same key gives the same bits in both
packages.  ``tests/test_torch_prng.py`` pins each function to
``jax.random``.

A key is an int64 tensor whose last axis holds the two 32-bit words
(``(..., 2)``); leading axes batch keys, as ``jax.vmap`` over keys does.
Words live in int64 and are masked to 32 bits after every add and left
shift: torch's uint32 has no shifts or bitwise ops on CUDA, and int32's
``>>`` is arithmetic.  Every integer step is exact on any device, so a
key, its bits and its uniforms are the same on the CPU and on the card;
only ``gumbel``'s ``log`` may round differently there (an ulp), which is
why the engine runs every keyed draw on its own device.
"""
from __future__ import annotations

from typing import Sequence

import torch

MASK = 0xFFFFFFFF
# threefry-2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# the smallest normal f32: gumbel's lower bound on its uniforms
_TINY = 1.1754943508222875e-38


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the count pair (x1, x2)
    under the key (k1, k2); every argument an int64 tensor of 32-bit
    words, broadcast together.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the key
    ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``: the hash of the count pair (0,
    data) under ``k``; ``data`` in [0, 2**32)."""
    if not 0 <= int(data) <= MASK:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    zero = torch.zeros((), dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], zero, zero + int(data))
    return torch.stack([y1, y2], dim=-1)


def _counts(shape: Sequence[int], device) -> torch.Tensor:
    """The low words of the row-major iota over ``shape`` (the high words
    are 0 below 2**32 elements)."""
    n = 1
    for d in shape:
        n *= int(d)
    if n > MASK:
        raise NotImplementedError("more than 2**32 random words")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(
        tuple(shape))


def _hash_iota(k: torch.Tensor, shape: Sequence[int]):
    """Both threefry words of each key over the iota of ``shape``:
    (..., *shape) each, the keys' batch axes first."""
    lo = _counts(shape, k.device)
    pad = (slice(None),) * (k.dim() - 1) + (None,) * len(shape)
    return threefry2x32(k[..., 0][pad], k[..., 1][pad],
                        torch.zeros_like(lo), lo)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` (the fold-like form of the
    partitionable mode): (..., num, 2) new keys.  The engine takes row 0
    as the request's next key and row 1 as the key of this draw."""
    y1, y2 = _hash_iota(k, (num,))
    return torch.stack([y1, y2], dim=-1)


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` under each key:
    (..., *shape) int64 words (the partitionable form, word 1 ^ word 2)."""
    y1, y2 = _hash_iota(k, shape)
    return y1 ^ y2


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1, scaled to [minval, maxval) by one fused
    multiply-add (as XLA emits it), then at least ``minval``."""
    bits = random_bits(k, shape)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span rounded to f32 on the host; fills, not
    # host->device copies, so that a CUDA graph can capture the draw
    lo = float(torch.tensor(minval, dtype=torch.float32))
    span = float(torch.tensor(maxval, dtype=torch.float32)
                 - torch.tensor(minval, dtype=torch.float32))
    scaled = torch.addcmul(torch.full_like(floats, lo), floats,
                           torch.full_like(floats, span))
    return torch.clamp_min(scaled, lo)


def gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` in mode "low", f32: ``-log(-log(u))`` over
    uniforms in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(k, shape, _TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis of f32 ``logits``:
    the argmax of Gumbel noise plus the logits, the lowest index among
    ties (the Gumbel-max trick: a comparator decision, no softmax).  The
    keys' batch axes lead ``logits``' axes: one key draws over all of
    ``logits``, a (R, 2) batch of keys draws row r of (R, n) logits with
    key r, as ``jax.vmap(jax.random.categorical)`` does."""
    shape = logits.shape[k.dim() - 1:]
    return torch.argmax(gumbel(k, shape) + logits, dim=-1)
