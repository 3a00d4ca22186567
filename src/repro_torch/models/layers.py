"""Layers of the dense decoder, as plain functions over the param tree.

Counterpart of ``repro.models.layers``: the same math in the same order
and at the same precision points -- norms and RoPE in f32 cast back to
the compute dtype; the prefill's attention is the JAX package's flash
path (``use_pallas``: f32 scores, masked at -inf), the decode's the
paged kernel's -- so the port's hidden states track the JAX package's.
"""
from __future__ import annotations

import dataclasses
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
    ``step_constants``: the RoPE table and, for a paged decode step, where
    each query's new K/V row goes and what the paged kernel reads.

    cos, sin    (B or 1, T, 1, hd/2) f32, ``rope_table`` of the positions
    blk, off    (B, T) int64: pool block and offset of each query's row
    tables      (B, nb) int32 block tables
    positions   (B,) int32 at T = 1, else (B, T): each query's position
    cpm         (B, T) int64 positions (the probe tap's operand)
    """

    cos: torch.Tensor
    sin: torch.Tensor
    blk: Optional[torch.Tensor] = None
    off: Optional[torch.Tensor] = None
    tables: Optional[torch.Tensor] = None
    positions: Optional[torch.Tensor] = None
    cpm: Optional[torch.Tensor] = None


def step_constants(cfg: ModelConfig, positions: torch.Tensor, *,
                   cache_pos: Optional[torch.Tensor] = None,
                   block_tables: Optional[torch.Tensor] = None,
                   block_size: Optional[int] = None) -> StepConstants:
    """The step's constants for ``positions`` ((B, T) or (T,)); with
    ``cache_pos`` ((B,) or (B, T)), ``block_tables`` (B, nb) and the
    pools' ``block_size``, the paged branch's too.  A (B,) ``cache_pos``
    covers a consecutive window of T queries."""
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    if cache_pos is None:
        return StepConstants(cos, sin)
    B, T = block_tables.shape[0], cos.shape[1]
    cpm = cache_pos if cache_pos.dim() == 2 else cache_pos[:, None]
    if cache_pos.dim() == 1 and T > 1:
        cpm = cpm + torch.arange(T, device=cache_pos.device)
    cpm = cpm.expand(B, T).long()
    blk = torch.gather(block_tables.long(), 1, cpm // block_size)
    return StepConstants(cos, sin, blk=blk, off=cpm % block_size,
                         tables=block_tables.to(torch.int32),
                         positions=(cpm[:, 0] if T == 1 else cpm).to(
                             torch.int32), cpm=cpm)


def activate(h_gate: torch.Tensor, h_up: Optional[torch.Tensor],
             kind: str) -> torch.Tensor:
    if kind == "silu_glu":
        return F.silu(h_gate) * h_up
    if kind == "gelu_glu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(h_gate, approximate="tanh") * h_up
    raise NotImplementedError(f"activation {kind!r}: the port has the GLU "
                              "forms only")


def mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = activate(x @ p["w_gate"], x @ p["w_up"], kind)
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

    ``cache is None``: the cache-less branch (prefill) -- attention over
    the T positions of ``x`` through ``ops.flash_attention`` (``causal``,
    ``window``: the plain version on the CPU, the kernel on the card);
    ``extra`` is the (k, v) the prefill builds its cache from.

    ``cache`` (the shared ``(num_blocks, bs, Hkv, hd)`` pools) with the
    paged fields of ``consts``: the paged branch -- each new K/V row is
    written into its pool block in place, then attention reads the pool
    through the table (``ops.paged_attention``); ``extra`` is the pools
    themselves.
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
        raise NotImplementedError(
            "the port's decode attention is the paged branch only: build "
            "the step constants with cache_pos and block_tables")
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
