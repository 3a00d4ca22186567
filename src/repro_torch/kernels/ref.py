"""Plain PyTorch versions of the port's kernels.

Each mirrors its counterpart in ``repro.kernels.ref`` operation for
operation, including where it rounds: the CPU tests hold these against
the JAX package, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  ``ops`` routes CPU tensors here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import attn_approx as approx


def fused_argmax_head_with_value(h: torch.Tensor, w: torch.Tensor):
    """(argmax_v(h @ w) int32, max_v(h @ w) f32); h (B, D), w (D, V).

    Products of the operands are exact in f32 and summed in f32 — what
    ``jnp.dot(..., preferred_element_type=f32)`` does.  ``torch.argmax``
    returns the first maximal index, so the lowest index wins ties."""
    logits = torch.matmul(h.float(), w.float())
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            torch.amax(logits, dim=-1))


def fused_argmax_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return fused_argmax_head_with_value(h, w)[0]


def argmax_head_split(h: torch.Tensor, w: torch.Tensor, plan):
    """A plain model of the CUDA argmax head's two passes, for the tests.

    ``plan`` is a ``fused_argmax_head.HeadPlan``.  Pass 1: rows in groups
    of ``plan.row_block``, each padded with zero rows; the vocabulary in
    ``plan.nsplit`` ranges of ``plan.split_ids`` ids, the last padded with
    zero columns (the zero-filled tail of W) that are masked to -inf; each
    (group, range) keeps every row's first maximum, and a range with no id
    gives (-inf, -1).  Pass 2: a row's partials merged in range order by
    "larger value, else lower index".  Returns (idx (R,) int32, val (R,)
    f32): ``fused_argmax_head_with_value`` of the same f32 logits."""
    r, d = h.shape
    v = w.shape[1]
    ids = plan.nsplit * plan.split_ids
    wp = torch.zeros((d, max(ids, v)), dtype=torch.float32)
    wp[:, :v] = w.float()
    pval = torch.full((r, plan.nsplit), -torch.inf)
    pidx = torch.full((r, plan.nsplit), -1, dtype=torch.int32)
    for g in range(0, r, plan.row_block):
        hg = torch.zeros((plan.row_block, d), dtype=torch.float32)
        hg[:min(plan.row_block, r - g)] = h[g:g + plan.row_block].float()
        logits = torch.matmul(hg, wp)
        logits[:, v:] = -torch.inf
        n = min(plan.row_block, r - g)
        for s in range(plan.nsplit):
            lo = s * plan.split_ids
            if lo >= v:
                continue
            seg = logits[:n, lo:lo + plan.split_ids]
            pval[g:g + n, s] = seg.amax(dim=-1)
            pidx[g:g + n, s] = torch.argmax(seg, dim=-1).to(torch.int32) + lo
    best_v, best_i = pval[:, 0].clone(), pidx[:, 0].clone()
    for s in range(1, plan.nsplit):
        take = _beats(pval[:, s], pidx[:, s], best_v, best_i)
        best_v = torch.where(take, pval[:, s], best_v)
        best_i = torch.where(take, pidx[:, s], best_i)
    return best_i.clamp(min=0), best_v


def topk_select(x: torch.Tensor, k: int):
    """Top-k over the last axis: (vals (..., k) f32, idxs (..., k) int32),
    values descending, the LOWEST index first among equal values -- the
    order of ``repro.kernels.ref.topk_select``'s k stable selection
    passes.  A stable descending sort keeps equal values in index order;
    plain ``torch.topk`` does not promise that."""
    vals, idxs = torch.sort(x.float(), dim=-1, descending=True, stable=True)
    return vals[..., :k], idxs[..., :k].to(torch.int32)


def _beats(v1, i1, v2, i2):
    """(v1, i1) before (v2, i2) in the top-k order: a larger value, or an
    equal one and a lower index; index -1 pads and comes after all."""
    return (i1 >= 0) & ((i2 < 0) | (v1 > v2) | ((v1 == v2) & (i1 < i2)))


def _merge_pairs(vals, idxs, k: int):
    """One tree of pairwise merges over the lists of (B, n, k) sorted
    (value, index) lists -> (B, k): entry j of a pair's left list goes to
    rank j plus the count of right-list entries that beat it, entry j of
    the right list to j plus the count of left-list entries it does not
    beat (the left list wins the ties only padding can make), ranks past
    k fall off, and an odd list out passes through."""
    b = vals.shape[0]
    while vals.shape[1] > 1:
        even = vals.shape[1] - vals.shape[1] % 2
        xv, xi = vals[:, 0:even:2], idxs[:, 0:even:2]
        yv, yi = vals[:, 1::2], idxs[:, 1::2]
        # y_beats[..., i, j]: right entry j beats left entry i
        y_beats = _beats(yv[..., None, :], yi[..., None, :], xv[..., :, None],
                         xi[..., :, None])
        j = torch.arange(k)
        rank = torch.cat([j + y_beats.sum(-1), j + (~y_beats).sum(-2)], -1)
        mv = torch.empty((b, xv.shape[1], 2 * k))
        mi = torch.empty((b, xv.shape[1], 2 * k), dtype=torch.int32)
        mv.scatter_(2, rank, torch.cat([xv, yv], -1))
        mi.scatter_(2, rank, torch.cat([xi, yi], -1))
        vals = torch.cat([mv[..., :k], vals[:, even:]], 1)
        idxs = torch.cat([mi[..., :k], idxs[:, even:]], 1)
    return vals[:, 0], idxs[:, 0]


TOPK_LISTS_PER_BLOCK = 32   # lists one merge block of the kernel takes


def topk_merge_tree(x: torch.Tensor, k: int, n_lists: int):
    """A plain model of the CUDA top-k head's two passes, for the tests.

    Pass 1: the last axis of x (B, V) split into ``n_lists`` ranges of
    ceil(V / n_lists) ids; each range's top k in ``topk_select``'s order,
    padded with (-inf, -1) past a range shorter than k.  Pass 2: the
    lists merged ``TOPK_LISTS_PER_BLOCK`` at a time by trees of pairwise
    rank merges (``_merge_pairs``), stage after stage, as the kernel's
    merge blocks do.  Returns (vals (B, k) f32, idxs (B, k) int32):
    ``topk_select(x, k)`` bit for bit whenever k <= V."""
    x = x.float()
    b, v = x.shape
    per = -(-v // n_lists)
    vals = torch.full((b, n_lists, k), -torch.inf)
    idxs = torch.full((b, n_lists, k), -1, dtype=torch.int32)
    for s in range(n_lists):
        seg = x[:, s * per:(s + 1) * per]
        n = min(k, seg.shape[1])
        if n:
            sv, si = topk_select(seg, n)
            vals[:, s, :n], idxs[:, s, :n] = sv, si + s * per
    while True:
        step = TOPK_LISTS_PER_BLOCK
        merged = [_merge_pairs(vals[:, g:g + step], idxs[:, g:g + step], k)
                  for g in range(0, vals.shape[1], step)]
        vals = torch.stack([mv for mv, _ in merged], 1)
        idxs = torch.stack([mi for _, mi in merged], 1)
        if vals.shape[1] == 1:
            return vals[:, 0], idxs[:, 0]


def fused_topk_head(h: torch.Tensor, w: torch.Tensor, k: int):
    """Top-k of ``h @ w`` over the vocabulary: (vals (B, k) f32, idxs
    (B, k) int32); h (B, D), w (D, V); f32 products summed in f32."""
    return topk_select(torch.matmul(h.float(), w.float()), k)


def verify_draft(h: torch.Tensor, w: torch.Tensor, cand: torch.Tensor):
    """Comparator-only speculative verification.

    h (B, T, D) hidden states at T consecutive positions (0 = the last
    committed token, 1..T-1 the drafts); w (D, V); cand (B, T-1) int32
    draft ids, -1 past each row's real width.  Returns (ids (B, T) int32
    = argmax per position, accept (B,) int32 = length of the leading run
    where ``ids[:, :T-1] == cand``).  The -1 padding never equals an id,
    so a ragged row's run stops at its width."""
    b, t, d = h.shape
    ids = fused_argmax_head(h.reshape(b * t, d), w).reshape(b, t)
    ok = (ids[:, :t - 1] == cand).to(torch.int32)
    accept = torch.cumprod(ok, dim=-1).sum(dim=-1).to(torch.int32)
    return ids, accept


def _positions(positions, b: int, t: int, device) -> torch.Tensor:
    """(B,) / (B, T) / scalar positions -> (B, T) int64."""
    pos = torch.as_tensor(positions, dtype=torch.int64, device=device)
    pos = pos.reshape((-1, t) if pos.ndim == 2 else (-1, 1))
    return pos.expand(b, t)


def _gather(q, k_pool, v_pool, block_tables, positions, window, dt):
    """q (B, T, Hq, hd)'s rows read through the block table: K and V
    (B, nb*bs, Hkv, hd) in ``dt`` and the (B, T, S) mask of the keys each
    query sees (<= its position, and > position - window with a
    window)."""
    b, t = q.shape[:2]
    hkv, hd = k_pool.shape[2:]
    pos = _positions(positions, b, t, q.device)
    bt = block_tables.long()
    k = k_pool[bt].to(dt).reshape(b, -1, hkv, hd)
    v = v_pool[bt].to(dt).reshape(b, -1, hkv, hd)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = kv_pos[None, None, :] <= pos[:, :, None]
    if window is not None:
        mask &= kv_pos[None, None, :] > pos[:, :, None] - window
    return k, v, mask


def paged_attention(q, k_pool, v_pool, block_tables, positions, *,
                    attn_approx: str = "exact",
                    window: Optional[int] = None):
    """Ragged decode attention read through a block table.

    q (B, Hq, hd) or (B, T, Hq, hd); pools (num_blocks, bs, Hkv, hd);
    block_tables (B, nb); positions (B,) or (B, T) — query t of row b
    attends over kv positions <= positions[b, t] (and > positions - window
    with a window).  Returns q's shape and dtype.

    Same precision points as ``repro.kernels.ref.paged_attention``: the
    scores are formed in q's dtype and scaled there, then masked at -1e30
    in f32; the probabilities are cast back to q's dtype before the PV
    product.  The weights are ``core.attn_approx.attn_weights`` of the
    mode: the softmax for 'exact', else the dense single-shot form of
    the kernel's online carry."""
    multi = q.ndim == 4
    if not multi:
        q = q[:, None]
    b, t, hq, hd = q.shape
    hkv = k_pool.shape[2]
    dt = q.dtype
    k, v, mask = _gather(q, k_pool, v_pool, block_tables, positions, window,
                         dt)
    scale = hd ** 0.5
    g = hq // hkv
    if g > 1:
        qg = q.reshape(b, t, hkv, g, hd)
        scores = torch.einsum("btkgh,bskh->bkgts", qg, k) / scale
        scores = scores.float()
        scores = torch.where(mask[:, None, None], scores, -1e30)
        probs = approx.attn_weights(scores, attn_approx).to(dt)
        out = torch.einsum("bkgts,bskh->btkgh", probs, v).reshape(
            b, t, hq, hd)
        return out if multi else out[:, 0]
    scores = torch.einsum("bthd,bshd->bhts", q, k) / scale
    scores = scores.float()
    scores = torch.where(mask[:, None], scores, -1e30)
    probs = approx.attn_weights(scores, attn_approx).to(dt)
    out = torch.einsum("bhts,bshd->bthd", probs, v)
    return out if multi else out[:, 0]


def paged_attention_split(q, k_pool, v_pool, block_tables, positions, *,
                          chunk_keys: int, attn_approx: str = "exact",
                          window: Optional[int] = None):
    """A plain model of the CUDA kernel's split-KV decode, for the tests:
    the kv positions split into chunks of ``chunk_keys``; each chunk's
    partial (m, l, acc) per query row from the mode's plain weights; then
    the merge in chunk order.  ``exact`` and ``pseudo`` weigh a chunk at
    its own max m_c and rescale it by exp(m_c - M), resp. 2^(m_c - M) (M
    the largest m_c); ``base2`` and ``pwl`` take each row's max M first
    (the kernel's pre-pass) and weigh every chunk at it, so every
    non-empty chunk carries m_c = M and the merge is a sum; ``maxonly``
    keeps the V row of the first chunk whose max is strictly the highest,
    so a tie goes to the earlier position.  An empty chunk (no visible
    key) weighs nothing.  Same operands and result as
    ``paged_attention``, in f32 arithmetic.  The CPU path keeps the
    unsplit ``paged_attention``."""
    attn_approx = approx.resolve(attn_approx)[0]
    multi = q.ndim == 4
    if not multi:
        q = q[:, None]
    b, t, hq, hd = q.shape
    hkv = k_pool.shape[2]
    g = hq // hkv
    k, v, vis = _gather(q, k_pool, v_pool, block_tables, positions, window,
                        torch.float32)
    scores = torch.einsum("btkgh,bskh->btkgs",
                          q.float().reshape(b, t, hkv, g, hd), k) / hd ** 0.5
    vis = vis[:, :, None, None, :].expand(scores.shape)
    premax = attn_approx in ("base2", "pwl")
    row_max = torch.amax(torch.where(vis, scores, -torch.inf), dim=-1)
    bi = torch.arange(b, device=q.device)[:, None, None, None]
    ki = torch.arange(hkv, device=q.device)[None, None, :, None]
    parts = []
    for c0 in range(0, k.shape[1], chunk_keys):
        cv = vis[..., c0:c0 + chunk_keys]
        s = torch.where(cv, scores[..., c0:c0 + chunk_keys], -torch.inf)
        vc = v[:, c0:c0 + chunk_keys].permute(0, 2, 1, 3)  # (B, Hkv, c, hd)
        m = torch.amax(s, dim=-1)                           # (B, T, Hkv, g)
        if attn_approx == "maxonly":
            iota = torch.arange(s.shape[-1], device=q.device)
            first = torch.amin(torch.where(s == m[..., None], iota,
                                           s.shape[-1]), dim=-1)
            live = m > -torch.inf
            acc = vc[bi, ki, first.clamp(max=s.shape[-1] - 1)]
            acc = torch.where(live[..., None], acc, 0.0)
            parts.append((m, live.float(), acc))
            continue
        if premax:    # a chunk with a visible key weighs at the row's max
            m = torch.where(m > -torch.inf, row_max, m)
        base = torch.where(m > -torch.inf, m, 0.0)
        d = torch.where(cv, s - base[..., None], 0.0)
        w = torch.where(cv, approx.weight_exp(d, attn_approx), 0.0)
        parts.append((m, w.sum(-1), torch.einsum("btkgs,bksh->btkgh", w,
                                                 vc)))
    if attn_approx == "maxonly":
        best = torch.full_like(parts[0][0], -torch.inf)
        l, acc = torch.zeros_like(parts[0][1]), torch.zeros_like(parts[0][2])
        for m, lc, ac in parts:
            take = m > best
            best = torch.where(take, m, best)
            l = torch.where(take, lc, l)
            acc = torch.where(take[..., None], ac, acc)
    else:
        mx = torch.amax(torch.stack([m for m, _, _ in parts]), dim=0)
        l, acc = 0.0, 0.0
        for m, lc, ac in parts:
            w = torch.where(m > -torch.inf,
                            approx.carry_scale(m - mx, attn_approx), 0.0)
            l = l + lc * w
            acc = acc + ac * w[..., None]
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(
        b, t, hq, hd).to(q.dtype)
    return out if multi else out[:, 0]


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Plain masked softmax attention with GQA by repeat (what the
    kernel avoids).  q (B, Hq, T, hd); k, v (B, Hkv, S, hd).  Query and
    key indices both count from 0; ``causal`` keeps keys <= the query's
    index, ``window`` keys > index - window.  Scores and probabilities
    in f32, masked at -inf; a row with no visible key gives 0.  Returns
    (B, Hq, T, hd) in q's dtype -- ``repro.kernels.ref.flash_attention``
    step for step."""
    hq, t, hd = q.shape[1], q.shape[2], q.shape[3]
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=1)
        v = torch.repeat_interleave(v, g, dim=1)
    scores = torch.einsum("bhtd,bhsd->bhts", q.float(),
                          k.float()) / (hd ** 0.5)
    q_idx = torch.arange(t, device=q.device)[:, None]
    k_idx = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx <= q_idx
    if window is not None:
        mask &= k_idx > q_idx - window
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)   # fully masked
    return torch.einsum("bhts,bhsd->bhtd", probs,
                        v.float()).to(q.dtype)


def online_softmax(x: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis, (B, V) -> (B, V) f32: the full
    softmax unit, the paper's baseline."""
    x = x.float()
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def softmax_stats(x: torch.Tensor):
    """(max, sum exp(x - max)) per row, both (B,) f32 -- the online
    softmax carry."""
    x = x.float()
    m = torch.amax(x, dim=-1)
    return m, torch.sum(torch.exp(x - m[:, None]), dim=-1)


UNIT_THREADS = 256          # threads of a softmax-unit chunk block


def _xor_tree(x, op):
    """The lanes of a warp (the last axis, 32) meeting by xor shuffles:
    lane i takes ``op(x[i], x[i ^ o])`` for o = 16, 8, 4, 2, 1; every
    lane ends with lane 0's value (``op`` is commutative)."""
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        x = op(x, x[..., lanes ^ o])
    return x[..., 0]


def softmax_stats_split(x: torch.Tensor, plan):
    """A plain model of the CUDA softmax-unit kernels' chunked fold, for
    the tests: ``softmax_stats`` of the same rows, in the kernels' order.

    ``plan`` is an ``online_softmax.UnitPlan``.  Each row splits into
    ``plan.nsplit`` chunks of ``plan.chunk`` elements (the last padded
    with -inf); thread t of a chunk's 256 holds elements (j * 256 + t) *
    vec + e, takes their max, then sums exp(x - max) over them in that
    order (from 0 where the chunk is all -inf); a warp's 32 lanes meet in
    an xor tree and the 8 warps in order.  The partials (m_i, l_i) then
    merge as one warp does: m = max m_i, and lane j sums l_i exp(m_i - m)
    (each product rounded) over partials j, j + 32, ... in order, the
    lanes meeting in an xor tree.  Returns (m (B,), l (B,)) f32.  Every
    step is elementwise across rows, so a row's bits do not depend on its
    batch-mates."""
    x = x.float()
    b, v = x.shape
    dev = x.device
    per = plan.chunk // UNIT_THREADS
    warps = UNIT_THREADS // 32
    xp = torch.full((b, plan.nsplit * plan.chunk), -torch.inf, device=dev)
    xp[:, :v] = x
    # (B, nsplit, j, t, e) -> each thread's elements in its order:
    # (B, nsplit, warp, lane, k) with k = j * vec + e
    xt = xp.reshape(b, plan.nsplit, per // plan.vec, UNIT_THREADS,
                    plan.vec).permute(0, 1, 3, 2, 4).reshape(
                        b, plan.nsplit, warps, 32, per)
    wmax = _xor_tree(torch.amax(xt, dim=-1), torch.maximum)  # max is exact
    m = wmax[..., 0]
    for w in range(1, warps):
        m = torch.maximum(m, wmax[..., w])
    base = torch.where(m == -torch.inf, 0.0, m)
    e = torch.exp(xt - base[..., None, None, None])
    s = torch.zeros(e.shape[:-1], device=dev)
    for k in range(per):
        s = s + e[..., k]
    wsum = _xor_tree(s, torch.add)
    l = wsum[..., 0]
    for w in range(1, warps):
        l = l + wsum[..., w]
    # the merge: lane j takes partials j, j + 32, ...; -inf pads
    lanes = -(-plan.nsplit // 32) * 32
    pm = torch.full((b, lanes), -torch.inf, device=dev)
    pl = torch.zeros((b, lanes), device=dev)
    pm[:, :plan.nsplit], pl[:, :plan.nsplit] = m, l
    pm, pl = pm.reshape(b, -1, 32), pl.reshape(b, -1, 32)
    rm = torch.amax(pm, dim=(1, 2))
    rbase = torch.where(rm == -torch.inf, 0.0, rm)
    terms = pl * torch.exp(pm - rbase[:, None, None])
    acc = torch.zeros((b, 32), device=dev)
    for i in range(terms.shape[1]):
        acc = acc + terms[:, i]
    return rm, _xor_tree(acc, torch.add)


def fused_xent_split(logits: torch.Tensor, labels: torch.Tensor, plan):
    """A plain model of the CUDA cross-entropy kernel, for the tests:
    ``softmax_stats_split``'s (m, l) of the rows under ``plan`` (an
    ``online_softmax.UnitPlan``), then ``(m + log l) - x[label]`` in f32,
    the label logit widened exactly from the logits' dtype.  (B, V), (B,)
    int -> (B,) f32; a row's bits do not depend on its batch-mates."""
    m, l = softmax_stats_split(logits, plan)
    label_logit = torch.gather(logits.float(), 1, labels.long()[:, None])
    return (m + torch.log(l)) - label_logit[:, 0]


def fused_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row softmax cross-entropy ``logsumexp(x) - x[label]``: (B, V),
    (B,) int -> (B,) f32."""
    x = logits.float()
    m = torch.amax(x, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(x - m[:, None]), dim=-1))
    label_logit = torch.gather(x, 1, labels.long()[:, None])[:, 0]
    return lse - label_logit
