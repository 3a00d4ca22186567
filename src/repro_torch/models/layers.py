"""Layers of the dense decoder, as plain functions over the param tree.

Counterpart of ``repro.models.layers``: the same math in the same order
and at the same precision points -- norms and RoPE in f32 cast back to
the compute dtype; the prefill's attention is the JAX package's flash
path (``use_pallas``: f32 scores, masked at -inf), the paged decode's
the paged kernel's, the dense decode's the reference's einsum -- so the
port's hidden states track the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    # The mean of the f32 squares accumulates in f64 and rounds once to
    # f32.  On the card torch.mean's f32 summation order follows the
    # number of rows, so an f32 mean would make a row's norm -- and its
    # greedy token at a near-tie -- depend on its batch-mates and on the
    # step's width; the f64 sum rounds to the same f32 in any order
    # (short of a sum within 1e-16 of an f32 rounding boundary).
    ms = torch.mean(xf * xf, dim=-1, keepdim=True, dtype=torch.float64)
    y = xf * torch.rsqrt(ms.float() + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def group_norm_heads(x: torch.Tensor, scale: torch.Tensor, n_heads: int,
                     eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm (RWKV's ``ln_x``) over x (..., H * hd), in f32
    cast back; eps fixed at 64e-5, not the config's.  Both means
    accumulate in f64, as ``rms_norm``'s, so a row's bits do not follow
    its batch-mates."""
    shp = x.shape
    xf = x.float().reshape(*shp[:-1], n_heads, -1)
    mu = torch.mean(xf, dim=-1, keepdim=True, dtype=torch.float64).float()
    c = xf - mu
    var = torch.mean(c * c, dim=-1, keepdim=True,
                     dtype=torch.float64).float()
    y = c * torch.rsqrt(var + eps)
    return (y.reshape(shp) * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotation angles at ``positions`` ((B, T) or
    (T,)), each (B or 1, T, 1, hd/2) f32: what ``rotate`` needs, the same
    for q and k and for every layer of a step."""
    freqs = rope_freqs(head_dim, theta, positions.device)   # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., T, hd/2)
    if ang.dim() == 2:
        ang = ang[None]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Split-halves rotation of x (B, T, H, hd) in f32 by a
    ``rope_table``."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, T, H, hd); positions (B, T) or (T,).  Split-halves rotation
    in f32."""
    return rotate(x, *rope_table(positions, x.shape[-1], theta))


@dataclasses.dataclass(frozen=True)
class StepConstants:
    """What every layer of one forward pass shares, computed once by
    ``step_constants``: the RoPE table and, for a decode step, where each
    query's new K/V row goes and what the attention reads.

    cos, sin    (B or 1, T, 1, hd/2) f32, ``rope_table`` of the positions
    cpm         (B or 1, T) int64: each query's cache position
    paged cache (``block_tables``):
    blk, off    (B, T) int64: pool block and offset of each query's row
    tables      (B, nb) int32 block tables
    positions   (B,) int32 at T = 1, else (B, T): each query's position
    dense cache (``cache_len``):
    slot        (B or 1, T) int64: the cache cell each query's K/V goes
                to -- its position, or ``position % window`` in a ring
    ring        whether the cache is the ring buffer of an architecture
                window (S == window)
    mask        (B or 1, 1, 1, T, S) bool: the keys each query sees
    rows        (B,) int64: the cache row of each batch row, or None when
                batch row b is cache row b
    """

    cos: torch.Tensor
    sin: torch.Tensor
    cpm: Optional[torch.Tensor] = None
    blk: Optional[torch.Tensor] = None
    off: Optional[torch.Tensor] = None
    tables: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None
    slot: Optional[torch.Tensor] = None
    ring: bool = False
    mask: Optional[torch.Tensor] = None
    rows: Optional[torch.Tensor] = None


def step_constants(cfg: ModelConfig, positions: torch.Tensor, *,
                   cache_pos: Optional[torch.Tensor] = None,
                   block_tables: Optional[torch.Tensor] = None,
                   block_size: Optional[int] = None,
                   cache_len: Optional[int] = None,
                   rows: Optional[torch.Tensor] = None,
                   window: Optional[int] = None) -> StepConstants:
    """The step's constants for ``positions`` ((B, T) or (T,)).  With
    ``cache_pos`` -- a scalar (every row at one position), (B,) (a
    consecutive window of T queries from each row's own position) or
    (B, T) -- either the paged branch's (``block_tables`` (B, nb) and the
    pools' ``block_size``) or the dense branch's (the cache's
    ``cache_len`` S, the optional cache ``rows`` and the architecture
    ``window`` of the mask).  A dense cache exactly ``window`` long is the
    reference's ring buffer (``repro/models/layers.py:299-330``): a query
    at position p writes cell p % window, and cell s holds position p -
    ((p - s) % window), visible while that is >= 0."""
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    if cache_pos is None:
        return StepConstants(cos, sin)
    T = cos.shape[1]
    cpm = cache_pos.long()
    if cpm.dim() == 0:
        cpm = (cpm + torch.arange(T, device=cpm.device))[None]
    elif cpm.dim() == 1:
        cpm = cpm[:, None] + torch.arange(T, device=cpm.device)
    if block_tables is None:
        kv = torch.arange(cache_len, device=cpm.device)
        ring = window is not None and cache_len == window
        if ring:
            slot = cpm % window
            m = cpm[:, :, None] - (cpm[:, :, None] - kv) % window >= 0
        else:
            slot = cpm
            m = kv <= cpm[:, :, None]
            if window is not None:
                m &= kv > cpm[:, :, None] - window
        return StepConstants(cos, sin, cpm=cpm, slot=slot, ring=ring,
                             mask=m[:, None, None], rows=rows)
    B = block_tables.shape[0]
    cpm = cpm.expand(B, T)
    blk = torch.gather(block_tables.long(), 1, cpm // block_size)
    return StepConstants(cos, sin, cpm=cpm, blk=blk, off=cpm % block_size,
                         tables=block_tables.to(torch.int32),
                         positions=(cpm[:, 0] if T == 1 else cpm).to(
                             torch.int32))


def activate(h_gate: torch.Tensor, h_up: Optional[torch.Tensor],
             kind: str) -> torch.Tensor:
    """The MLP's nonlinearity: a GLU form (``*_glu``: the gate times
    ``h_up``) or a plain one over ``h_gate`` alone.  ``jax.nn.gelu``
    defaults to the tanh approximation, so both gelu forms take it."""
    if kind == "silu_glu":
        return F.silu(h_gate) * h_up
    if kind == "gelu_glu":
        return F.gelu(h_gate, approximate="tanh") * h_up
    if kind == "gelu":
        return F.gelu(h_gate, approximate="tanh")
    if kind == "relu":
        return F.relu(h_gate)
    if kind in ("squared_relu", "relu_sq"):
        r = F.relu(h_gate)
        return r * r
    raise ValueError(f"activation {kind!r}: expected silu_glu, gelu_glu, "
                     "gelu, relu, squared_relu or relu_sq")


def mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """``activate(x @ w_gate, x @ w_up) @ w_out`` for a GLU kind,
    ``activate(x @ w_in) @ w_out`` otherwise."""
    if kind.endswith("_glu"):
        h = activate(x @ p["w_gate"], x @ p["w_up"], kind)
    else:
        h = activate(x @ p["w_in"], None, kind)
    return h @ p["w_out"]


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int):
    return x.reshape(*x.shape[:-1], n_heads, head_dim)


# Probe hook (repro_torch.probe): when set, the paged branch calls
# ``_ATTN_TAP.append((q, k_pool, v_pool, block_tables, cpm))`` once per
# layer per call, after the new K/V rows are in the pools and before the
# kernel.  The pools are written in place and their blocks reused once a
# request is done, so a tap must use the operands before it returns.
# Leave None in production paths.
_ATTN_TAP = None


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              consts: StepConstants, causal: bool = True,
              window: Optional[int] = None, cache: Optional[dict] = None):
    """Returns ``(out, extra)``; ``consts`` is the pass's
    ``step_constants``.

    ``cache is None``: the cache-less branch (prefill, ``lm.forward``) --
    attention over the T positions of ``x`` through
    ``ops.flash_attention`` (``causal``, ``window``: the plain version on
    the CPU, the kernel on the card); ``extra`` is the (k, v) the prefill
    builds its cache from.

    ``cache`` with the paged fields of ``consts``: the shared ``(num_blocks,
    bs, Hkv, hd)`` pools -- each new K/V row is written into its pool
    block in place, then attention reads the pool through the table
    (``ops.paged_attention``); ``extra`` is the pools themselves.

    ``cache`` with the dense fields: the dense cache ``(N, S, Hkv, hd)``
    -- each new K/V row is written at its cell (``consts.slot``: its
    position, or position % window in the ring buffer of a windowed layer
    whose cache is exactly ``window`` long) of its cache row in place,
    then every query attends over its row's S cells under ``consts.mask``
    in plain torch, as the reference's XLA einsum does: scores in the
    compute dtype then f32, masked at -1e30, softmax, cast back.
    """
    B, T, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], hq, hd)
    k = _split_heads(x @ p["wk"], hkv, hd)
    v = _split_heads(x @ p["wv"], hkv, hd)
    if "q_norm" in p:                        # qk-norm before RoPE
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotate(q, consts.cos, consts.sin)
    k = rotate(k, consts.cos, consts.sin)

    if cache is None:
        # (B, T, H, hd) -> (B, H, T, hd) views; the kernel takes strides,
        # and its output keeps q's layout, so the reshape back is free
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window)
        out = o.transpose(1, 2).reshape(B, T, hq * hd)
        return out @ p["wo"], (k, v)

    if consts.tables is None:
        return _dense_attention(p, q, k, v, cfg, consts, cache)
    # The new K/V rows go into the shared pools IN PLACE.  The JAX package
    # scatters into a donated copy (``.at[].set``); PyTorch mutates the
    # pool tensor the store owns.  Rows that repeat another row's (token,
    # position) -- the engine's pow2 row padding and repeat-last query
    # padding -- write identical values to the identical cell, so the
    # duplicate indices are harmless.
    cache["k"].index_put_((consts.blk, consts.off), k.to(cache["k"].dtype))
    cache["v"].index_put_((consts.blk, consts.off), v.to(cache["v"].dtype))
    if _ATTN_TAP is not None:
        _ATTN_TAP.append((q, cache["k"], cache["v"], consts.tables,
                          consts.cpm))
    o = ops.paged_attention(q[:, 0] if T == 1 else q, cache["k"],
                            cache["v"], consts.tables, consts.positions,
                            attn_approx=cfg.attn_approx,
                            window=cfg.attn_window)
    out = o.reshape(B, T, hq * hd).to(x.dtype)
    return out @ p["wo"], cache


def _dense_attention(p, q, k, v, cfg: ModelConfig, consts: StepConstants,
                     cache: dict):
    """The dense-cache branch of ``attention`` (reference
    ``layers.py:299-360`` and the grouped decode einsum after it): write
    each query's K/V row at (its cache row, its cell), in place -- rows
    repeating another's (token, position) write identical values -- then
    grouped-query attention over the cache rows.  The ring buffer takes
    one query a row (T = 1), as the reference's does."""
    B, T, hq, hd = q.shape
    hkv, dt = cfg.n_kv_heads, q.dtype
    if consts.ring and T != 1:
        raise NotImplementedError(
            f"a ring-buffer cache takes T = 1 query a row; got T = {T}")
    cell = consts.slot.expand(B, T)
    rows = consts.rows if consts.rows is not None else torch.arange(
        B, device=q.device)
    cache["k"].index_put_((rows[:, None], cell), k.to(cache["k"].dtype))
    cache["v"].index_put_((rows[:, None], cell), v.to(cache["v"].dtype))
    ck, cv = cache["k"], cache["v"]
    if consts.rows is not None:
        ck, cv = ck[rows], cv[rows]
    qg = q.reshape(B, T, hkv, hq // hkv, hd)
    scores = torch.einsum("btkgh,bskh->bkgts", qg, ck.to(dt)) / math.sqrt(hd)
    scores = scores.float().masked_fill(~consts.mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bkgts,bskh->btkgh", probs, cv.to(dt))
    return out.reshape(B, T, hq * hd) @ p["wo"], cache
