"""Layers of the dense decoder, as plain functions over the param tree.

Counterpart of ``repro.models.layers``: the same math in the same order
and at the same precision points -- norms and RoPE in f32 cast back to
the compute dtype; the prefill's attention is the JAX package's flash
path (``use_pallas``: f32 scores, masked at -inf), the paged decode's
the paged kernel's, the dense decode's the reference's einsum -- so the
port's hidden states track the JAX package's.
"""
from __future__ import annotations

import contextlib
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
    src         (B * T,) int64 or None: for each query, the first query
                of the step that writes the same cache cell; a query
                writes that query's K/V (set for the moe family only,
                ``write_sources``)
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
    src: Optional[torch.Tensor] = None


def write_sources(cells: torch.Tensor) -> torch.Tensor:
    """For each entry of ``cells`` (flat cache cell ids), the index of the
    first entry with the same id.  A padding row repeats a live row's
    slot, token and position; in a dense model it computes the live
    row's K/V bit for bit, so the duplicate write is harmless, but behind
    a capacity-dropping MoE layer it can lose choices the live row keeps
    (it comes last in rank order) and its K/V then differ.  Writing the
    first writer's K/V from every duplicate makes the cell's value
    independent of the order the writes land in (the card's
    ``index_put_`` gives none) and keeps the live row's own K/V, as the
    reference's dense layout does (each padded row attends over its own
    copy of the cache, and only the live rows are written back)."""
    n = cells.numel()
    flat = cells.reshape(-1)
    idx = torch.arange(n, device=cells.device)
    return torch.where(flat[:, None] == flat[None, :], idx[None, :],
                       n).amin(dim=1)


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
        src = None
        if cfg.moe is not None and rows is not None:
            src = write_sources(rows[:, None] * cache_len
                                + slot.expand(rows.shape[0], T))
        return StepConstants(cos, sin, cpm=cpm, slot=slot, ring=ring,
                             mask=m[:, None, None], rows=rows, src=src)
    B = block_tables.shape[0]
    cpm = cpm.expand(B, T)
    blk = torch.gather(block_tables.long(), 1, cpm // block_size)
    off = cpm % block_size
    return StepConstants(cos, sin, cpm=cpm, blk=blk, off=off,
                         tables=block_tables.to(torch.int32),
                         positions=(cpm[:, 0] if T == 1 else cpm).to(
                             torch.int32),
                         src=(write_sources(blk * block_size + off)
                              if cfg.moe is not None else None))


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
              consts: Optional[StepConstants], causal: bool = True,
              window: Optional[int] = None, cache: Optional[dict] = None,
              kv_x: Optional[torch.Tensor] = None):
    """Returns ``(out, extra)``; ``consts`` is the pass's
    ``step_constants``.

    ``cache is None``: the cache-less branch (prefill, ``lm.forward``) --
    attention over the T positions of ``x`` through
    ``ops.flash_attention`` (``causal``, ``window``: the plain version on
    the CPU, the kernel on the card); ``extra`` is the (k, v) the prefill
    builds its cache from.  With ``kv_x`` (B, S, D), cross-attention: K
    and V come from ``kv_x``, nothing is rotated (``consts`` may be
    None), T queries over S keys through the same call.

    ``cache`` without a cache position (``consts`` None or without
    ``cpm``): the read-only cache of a cross-attention decode step, ``{"k",
    "v"}`` (B, S, Hkv, hd) -- every query attends over all S rows, which
    are never written, in plain torch in the reference's order
    (``repro/models/layers.py:362-363`` and the einsum after it): scores in
    the compute dtype then f32, softmax, cast back; ``extra`` is None.

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
    if cache is not None and (consts is None or consts.cpm is None):
        return _read_only_attention(p, q, cfg, cache), None
    src = x if kv_x is None else kv_x
    k = _split_heads(src @ p["wk"], hkv, hd)
    v = _split_heads(src @ p["wv"], hkv, hd)
    if "q_norm" in p:                        # qk-norm before RoPE
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if kv_x is not None:
        # cross-attention: no RoPE, no mask, T queries over S keys
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=False)
        return o.transpose(1, 2).reshape(B, T, hq * hd) @ p["wo"], None
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

    if consts.src is not None:
        k, v = _first_writes(k, consts.src), _first_writes(v, consts.src)
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


def _first_writes(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) K or V with each query's row replaced by its cell's
    first writer's (``StepConstants.src``)."""
    B, T = t.shape[:2]
    return t.reshape(B * T, *t.shape[2:])[src].view(t.shape)


def _read_only_attention(p, q, cfg: ModelConfig, cache: dict):
    """Every query over all rows of a read-only cache (cross K/V), GQA by
    repeat, no mask: the reference's order of operations."""
    B, T, hq, hd = q.shape
    dt = q.dtype
    g = hq // cfg.n_kv_heads
    k, v = cache["k"].to(dt), cache["v"].to(dt)
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    probs = torch.softmax(scores.float(), dim=-1).to(dt)
    out = torch.einsum("bhts,bshd->bthd", probs, v)
    return out.reshape(B, T, hq * hd) @ p["wo"]


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


# ---------------------------------------------------------------------------
# MoE (top-k, capacity factor): the reference's two executors and its
# single-device oracle (``repro/models/layers.py:453-618``), in index form
# ---------------------------------------------------------------------------
def moe_route(xf: torch.Tensor, router: torch.Tensor, spec):
    """Per-token routing (reference ``_route``): f32 router logits,
    softmax, the top-k probabilities and their experts, renormalised to
    sum 1 when k > 1.  Returns (probs (N, E) f32, vals (N, k), idx (N, k)
    int64).  Top-k is a stable descending sort, so equal probabilities
    give the lower expert first, as ``jax.lax.top_k`` does (``torch.topk``
    on the card promises no order among ties)."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :spec.top_k], idx[:, :spec.top_k]
    if spec.top_k > 1:
        vals = vals / vals.sum(dim=-1, keepdim=True)
    return probs, vals, idx


def moe_aux_loss(probs: torch.Tensor, idx: torch.Tensor,
                 n_experts: int, data=None) -> torch.Tensor:
    """Switch-style load balance, ``E * sum_e f_e * P_e`` (f32 scalar):
    f_e the mean over tokens of the choices routed to e, P_e the mean
    router probability.

    ``data`` (a data group, the tokens one block of the global batch):
    both means are over the GLOBAL tokens -- the routed counts and the
    token count summed over the group (kind ``"aux"``, E + 1 f32) -- and
    the result is this rank's share, ``E * sum_e f_e * sum_n probs[n,
    e] / N``: the shares' sum over the group is the global router loss,
    and each rank's probabilities get their gradient ``E f_e / N`` once
    (the counts carry none).  A product of the ranks' own means, or a
    1 / D share of the global loss, would not be it."""
    onehot = (idx[..., None] == torch.arange(
        n_experts, device=idx.device)).float()               # (N, k, E)
    if data is None:
        f = onehot.sum(dim=1).mean(dim=0)
        return n_experts * torch.sum(f * probs.mean(dim=0))
    counts = torch.cat([onehot.sum(dim=(0, 1)),
                        onehot.new_full((1,), float(idx.shape[0]))])
    counts = data.all_reduce_sum(counts, "aux")
    n = counts[-1]
    return n_experts * torch.sum(counts[:-1] / n * (probs.sum(dim=0) / n))


# While a caller holds it (``count_kept``), each MoE call appends the
# choices it keeps -- over all E experts at the capacity, a device scalar,
# so no host sync -- to this list; None otherwise.
_KEPT: Optional[list] = None


@contextlib.contextmanager
def count_kept():
    """Inside: yields a list to which every MoE call appends its kept
    choices (``moe_slots``' keep mask summed), in call order; a unit
    recomputed in the backward appends again."""
    global _KEPT
    outer, _KEPT = _KEPT, []
    try:
        yield _KEPT
    finally:
        _KEPT = outer


def moe_slots(idx: torch.Tensor, spec, group: int):
    """Each choice's slot in its expert: the choices (N, k) in groups of
    ``group`` consecutive tokens are ranked within their expert in
    (token, choice) order -- token-major, choice-minor, the lower token
    first -- and a choice whose rank reaches the group's capacity,
    ``ceil(cf * group * k / E)`` slots an expert (at least 1), is
    dropped.  Returns (rank (N, k) int64, keep (N, k) bool, capacity).
    Static shapes and no host sync: a decode step stays capturable."""
    n_tok, k = idx.shape
    cap = max(1, int(math.ceil(
        spec.capacity_factor * group * spec.top_k / spec.num_experts)))
    e = idx.reshape(n_tok // group, group * k)
    onehot = (e[..., None] == torch.arange(
        spec.num_experts, device=idx.device)).long()         # (G, n*k, E)
    before = onehot.cumsum(dim=1) - onehot
    rank = before.gather(2, e[..., None])[..., 0].reshape(n_tok, k)
    return rank, rank < cap, cap


def _expert_share(p: dict, xf: torch.Tensor, vals: torch.Tensor,
                  idx: torch.Tensor, spec, group: int, experts,
                  activation: str) -> torch.Tensor:
    """The routed sum of one expert range's kept choices, (N, d) in x's
    dtype.  Every token is routed over all E experts at the global
    capacity (``moe_slots``); the experts in ``[lo, hi)`` -- the leaves of
    ``p`` hold exactly those -- fill a (hi - lo, G * C, d) buffer, one
    slot a kept choice (group g's slots at [g C, (g + 1) C)), run as one
    batched GEMM an expert, and each kept choice gathers its slot's output
    times its routing weight.  A choice that is dropped or whose expert
    lies outside the range goes to one spare row that is discarded, so
    that row alone takes more than one write, and no kept slot is ever
    written twice."""
    n_tok, d = xf.shape
    k = idx.shape[1]
    lo, hi = experts
    n_loc = hi - lo
    if p["w_gate"].shape[0] != n_loc:
        raise ValueError(f"expert range {experts} but the layer holds "
                         f"{p['w_gate'].shape[0]} experts")
    rank, keep, cap = moe_slots(idx, spec, group)
    if _KEPT is not None:
        _KEPT.append(keep.sum())
    slots = (n_tok // group) * cap
    g = torch.arange(n_tok, device=xf.device)[:, None] // group
    rel = idx - lo
    keep = keep & (rel >= 0) & (rel < n_loc)
    dest = torch.where(keep, rel * slots + g * cap + rank,
                       n_loc * slots).reshape(-1)
    buf = xf.new_zeros((n_loc * slots + 1, d))
    buf.index_copy_(0, dest, xf[:, None].expand(n_tok, k, d).reshape(-1, d))
    ein = buf[:-1].view(n_loc, slots, d)
    if activation.endswith("_glu"):
        h = activate(torch.bmm(ein, p["w_gate"]), torch.bmm(ein, p["w_up"]),
                     activation)
    else:
        h = activate(torch.bmm(ein, p["w_gate"]), None, activation)
    eout = torch.bmm(h, p["w_out"]).reshape(n_loc * slots, d)
    flat = torch.cat([eout, eout.new_zeros((1, d))])
    w = (vals * keep).to(xf.dtype).reshape(-1, 1)
    return (flat[dest] * w).view(n_tok, k, d).sum(dim=1)


def _moe(p: dict, x: torch.Tensor, cfg: ModelConfig, group: int, experts,
         data=None):
    spec = cfg.moe
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    probs, vals, idx = moe_route(xf, p["router"], spec)
    aux = moe_aux_loss(probs, idx, spec.num_experts, data)
    if experts is None:
        experts = (0, spec.num_experts)
    y = _expert_share(p, xf, vals, idx, spec, group, experts,
                      cfg.activation).view(B, T, d)
    if "shared" in p:
        y = y + mlp(p["shared"], x, cfg.activation)
    return y, aux


def moe_scatter(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                experts=None):
    """The decode executor (reference ``moe_scatter``): one group of all
    N = B * T tokens of the call, capacity ``ceil(cf * N * k / E)``.
    ``experts`` (lo, hi) is the range the leaves hold (default all E);
    the shared expert, where ``p`` has one, is added after the routed
    sum.  Returns (y (B, T, d), aux)."""
    return _moe(p, x, cfg, x.shape[0] * x.shape[1], experts)


def moe_gshard(p: dict, x: torch.Tensor, cfg: ModelConfig,
               group_size: int = 4096, *, experts=None, data=None):
    """The prefill / forward executor (reference ``moe_gshard``): each
    row's T tokens in groups of ``n = min(group_size, T)``, capacity
    ``ceil(cf * n * k / E)`` a group.  The reference's one-hot dispatch
    and combine tensors (G, n, E, C) are not built; the index form keeps
    the same choices with the same weights.  A T that ``n`` does not
    divide fails in the reference's reshape, and raises here.  ``data``
    (a data group, training on a mesh's block of the batch's rows): the
    router loss's share over the global means (``moe_aux_loss``); the
    groups lie within a row, so cutting rows leaves every choice, slot
    and drop as the whole batch has it."""
    B, T, _ = x.shape
    n = min(group_size, T)
    if T % n:
        raise ValueError(f"moe_gshard: T={T} is not a multiple of the group "
                         f"size {n}")
    return _moe(p, x, cfg, n, experts, data)


def moe_dense_oracle(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Every expert over every token, masked by the routing weights: no
    capacity, no drops (reference ``moe_dense_oracle``)."""
    spec = cfg.moe
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    probs, vals, idx = moe_route(xf, p["router"], spec)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(spec.num_experts):
        pe = {name: p[name][e] for name in ("w_gate", "w_up", "w_out")}
        if not cfg.activation.endswith("_glu"):
            pe["w_in"] = pe.pop("w_gate")
        w_e = torch.where(idx == e, vals, 0.0).sum(dim=-1)
        out += w_e[:, None] * mlp(pe, xf, cfg.activation).float()
    if "shared" in p:
        out += mlp(p["shared"], xf, cfg.activation).float()
    aux = moe_aux_loss(probs, idx, spec.num_experts)
    return out.to(x.dtype).reshape(B, T, d), aux


def moe_layer(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              impl: str = "gshard", group_size: int = 4096, experts=None,
              data=None):
    """The MoE feed-forward by ``impl`` (``oracle``, ``gshard`` or
    ``scatter``; the reference's ``ep``, on a mesh with no data axis, is
    ``scatter`` over a rank's ``experts`` followed by the caller's
    all-reduce).  ``data``, a training rank's data group, reaches the
    gshard executor's router loss (``sharding.train_plan`` refuses any
    other executor under a data axis)."""
    if impl == "oracle":
        return moe_dense_oracle(p, x, cfg)
    if impl == "gshard":
        return moe_gshard(p, x, cfg, group_size, experts=experts, data=data)
    if impl in ("scatter", "ep"):
        return moe_scatter(p, x, cfg, experts=experts)
    raise ValueError(f"moe impl {impl!r}: expected oracle, gshard, scatter "
                     "or ep")
