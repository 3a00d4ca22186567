"""Layers of the dense decoder, as plain functions over the param tree.

Counterpart of ``repro.models.layers``: the same math in the same order
and at the same precision points -- norms and RoPE in f32 cast back to
the compute dtype; the prefill's attention is the JAX package's flash
path (``use_pallas``: f32 scores, masked at -inf), the decode's the
paged kernel's -- so the port's hidden states track the JAX package's.
"""
from __future__ import annotations

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


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, T, H, hd); positions (B, T) or (T,).  Split-halves rotation
    in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., T, hd/2)
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


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
              positions: torch.Tensor, causal: bool = True,
              window: Optional[int] = None, cache: Optional[dict] = None,
              cache_pos: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None):
    """Returns ``(out, extra)``.

    ``cache is None``: the cache-less branch (prefill) -- attention over
    the T positions of ``x`` through ``ops.flash_attention`` (``causal``,
    ``window``: the plain version on the CPU, the kernel on the card);
    ``extra`` is the (k, v) the prefill builds its cache from.

    ``cache`` (the shared ``(num_blocks, bs, Hkv, hd)`` pools) with
    ``cache_pos`` ((B,) or (B, T)) and ``block_tables`` (B, nb): the
    paged branch -- each new K/V row is written into its pool block in
    place, then attention reads the pool through the table
    (``ops.paged_attention``); ``extra`` is the pools themselves.
    """
    B, T, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(x @ p["wq"], hq, hd)
    k = _split_heads(x @ p["wk"], hkv, hd)
    v = _split_heads(x @ p["wv"], hkv, hd)
    if "q_norm" in p:                        # qk-norm before RoPE
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        # (B, T, H, hd) -> (B, H, T, hd) views; the kernel takes strides,
        # and its output keeps q's layout, so the reshape back is free
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window)
        out = o.transpose(1, 2).reshape(B, T, hq * hd)
        return out @ p["wo"], (k, v)

    if cache_pos is None or block_tables is None:
        raise NotImplementedError(
            "the port's decode attention is the paged branch only: pass "
            "cache_pos and block_tables")
    bs = cache["k"].shape[1]
    # (B, T) per-query positions; a (B,) base covers a consecutive window
    cpm = cache_pos if cache_pos.dim() == 2 else cache_pos[:, None]
    if cache_pos.dim() == 1 and T > 1:
        cpm = cpm + torch.arange(T, device=cache_pos.device)
    cpm = cpm.expand(B, T).long()
    blk = torch.gather(block_tables.long(), 1, cpm // bs)   # (B, T)
    off = cpm % bs
    # The new K/V rows go into the shared pools IN PLACE.  The JAX package
    # scatters into a donated copy (``.at[].set``); PyTorch mutates the
    # pool tensor the store owns.  Rows that repeat another row's (token,
    # position) -- the engine's pow2 row padding and repeat-last query
    # padding -- write identical values to the identical cell, so the
    # duplicate indices are harmless.
    cache["k"].index_put_((blk, off), k.to(cache["k"].dtype))
    cache["v"].index_put_((blk, off), v.to(cache["v"].dtype))
    bt = block_tables.to(torch.int32)
    if _ATTN_TAP is not None:
        _ATTN_TAP.append((q, cache["k"], cache["v"], bt, cpm))
    if T == 1:
        o = ops.paged_attention(q[:, 0], cache["k"], cache["v"], bt,
                                cpm[:, 0].to(torch.int32),
                                attn_approx=cfg.attn_approx,
                                window=cfg.attn_window)
    else:
        o = ops.paged_attention(q, cache["k"], cache["v"], bt,
                                cpm.to(torch.int32),
                                attn_approx=cfg.attn_approx,
                                window=cfg.attn_window)
    out = o.reshape(B, T, hq * hd).to(x.dtype)
    return out @ p["wo"], cache

