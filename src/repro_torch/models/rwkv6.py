"""RWKV6 ("Finch") blocks: time-mix with data-dependent decay + channel-mix.

Counterpart of ``repro.models.rwkv6``, mirrored op for op (not upstream
Finch): static ``mu`` mixing coefficients on r/k/v/w/g (no token-shift
LoRAs), the decay ``w_t = exp(-exp(w0 + (xw @ wA) @ wB))`` with no
tanh and its second product in f32, a bonus ``u`` per channel, each
half's token shift holding that half's NORMED input, and the recurrence
in f32:

    kv_t = k_t (x) v_t            (outer product per head, (K, V))
    out_t = r_t . (S + u * kv_t)
    S = w_t * S + kv_t

State per layer and sequence: ``shift1`` (D,) and ``shift2`` (D,) in the
compute dtype, ``wkv`` (H, hd, hd) f32.  A block returns its shifts in
f32 (the reference's ``astype``); a store of another dtype casts them on
write, exactly (they are compute-dtype values).  The recurrence is the
reference's ``lax.scan``, outside any Pallas kernel: here a plain loop
over T in the same order of operations (``wkv_scan``).

Under tensor parallelism (``cfg.shard`` a split trunk, ``group`` its
ranks) a layer holds the rank's whole heads (``width``): r, k, v, g, the
decay and the bonus at its channels, ``wkv`` its heads, the group norm
over them alone; ``w_o``'s rows give a partial sum, all-reduced before
the residual.  The channel-mix's ``kv`` is a partial sum over the rank's
d_ff rows: all-reduced first, its product with the rank's ``sigmoid(xr
@ w_r_cm)`` columns is all-gathered (``rwkv_channel_mix``).  The shifts
stay full width.

Every collective carries its derivative (``parallel.comm``): the
time-mix output is ``reduce_from_group``; the column-parallel
projections (w_r, w_k, w_v, w_g, the decay LoRA's wB, w_k_cm, w_r_cm)
read their inputs through ``copy_to_group``, so the gradients of the
replicated ``mu_*`` and ``wA``, which act ahead of them, are whole on
every rank; ``kv`` is ``sum_to_group`` (a rank reads only its columns of
the sum, so its part's gradient is the sum of the ranks' column
gradients) and the product ``gather_from_group`` (each rank takes back
its own columns' gradient).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import group_norm_heads, rms_norm
from repro_torch.parallel import comm

LORA = 64                  # the decay LoRA's rank
# f32 elements of k (x) v (and u * that) a scan precomputes at once
KV_CHUNK = 1 << 26


def width(cfg: ModelConfig) -> int:
    """The time-mix channels the layers hold, ``rwkv_head_size`` a head:
    D, or under a split trunk the rank's heads' (``cfg.shard.chan``)."""
    sh = cfg.shard
    if sh is not None and sh.trunk:
        return sh.chan[1] - sh.chan[0]
    return cfg.d_model


def layer_shapes(cfg: ModelConfig, L: int) -> dict:
    """The layer's leaves stacked over ``L`` layers, as
    ``weights.param_shapes`` lists them: (shape, init), init a fan-in
    (normal / sqrt(fan_in)), None (zeros), ``("full", c)`` (the constant
    c) or ``("std", s)`` (normal * s) -- ``init_rwkv_layer``'s draws.  On
    a rank's view, at its heads' ``width`` and its d_ff."""
    d, f, c = cfg.d_model, cfg.d_ff, width(cfg)
    half = ("full", 0.5)
    return {
        "ln1": ((L, d), None), "ln2": ((L, d), None),
        "mu_r": ((L, d), half), "mu_k": ((L, d), half),
        "mu_v": ((L, d), half), "mu_w": ((L, d), half),
        "mu_g": ((L, d), half),
        "w_r": ((L, d, c), d), "w_k": ((L, d, c), d),
        "w_v": ((L, d, c), d), "w_g": ((L, d, c), d),
        "w0": ((L, c), ("full", -6.0)),
        "wA": ((L, d, LORA), d), "wB": ((L, LORA, c), LORA),
        "u": ((L, c), ("std", 0.1)),
        "ln_x": ((L, c), ("full", 1.0)),
        "w_o": ((L, c, d), d),
        "mu_k_cm": ((L, d), half), "mu_r_cm": ((L, d), half),
        "w_k_cm": ((L, d, f), d), "w_v_cm": ((L, f, d), f),
        "w_r_cm": ((L, d, c), d),
    }


def init_state(cfg: ModelConfig, lead: tuple, dtype, device) -> dict:
    """A fresh state with leading axes ``lead`` (a batch, or (layers,
    batch)): ``shift1`` / ``shift2`` (*lead, D) in ``dtype``, ``wkv``
    (*lead, H, hd, hd) f32, zeros; H the layers' heads (``width``)."""
    d, hd = cfg.d_model, cfg.rwkv_head_size
    return {"shift1": torch.zeros((*lead, d), dtype=dtype, device=device),
            "shift2": torch.zeros((*lead, d), dtype=dtype, device=device),
            "wkv": torch.zeros((*lead, width(cfg) // hd, hd, hd),
                               dtype=torch.float32, device=device)}


def _lerp(x: torch.Tensor, prev: torch.Tensor,
          mu: torch.Tensor) -> torch.Tensor:
    return x + (prev - x) * mu.to(x.dtype)


def _shifted(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Each position's previous input: the state's ``shift`` before the
    first."""
    return torch.cat([shift[:, None].to(x.dtype), x[:, :-1]], dim=1)


def wkv_scan(S: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """The recurrence over T in f32: S (B, H, K, V); r, k, v, w (B, T, H,
    hd); u (H, hd).  Returns (out (B, T, H, hd), S after the last
    token).  ``kv_t`` and ``u * kv_t`` are elementwise and come first, a
    chunk of tokens at a time; then per token ``r_t . (S + u kv_t)`` and
    ``w_t * S + kv_t``, each product rounded before its sum, as the
    reference's step -- four kernels a token over (B * H)-batched
    views, the per-token operands unbound once a chunk."""
    B, T, H, hd = r.shape
    n = B * H
    rt = r.permute(1, 0, 2, 3).reshape(T, n, 1, hd).unbind(0)
    wt = w.permute(1, 0, 2, 3).reshape(T, n, hd, 1).unbind(0)
    kt = k.permute(1, 0, 2, 3).reshape(T, n, hd)
    vt = v.permute(1, 0, 2, 3).reshape(T, n, hd)
    uk = u.reshape(1, H, hd, 1).expand(B, H, hd, 1).reshape(1, n, hd, 1)
    S = S.reshape(n, hd, hd)
    step = max(1, KV_CHUNK // (n * hd * hd))
    outs = []
    for t0 in range(0, T, step):
        kv = kt[t0:t0 + step, :, :, None] * vt[t0:t0 + step, :, None, :]
        ukv = uk * kv
        for i, (kv_i, ukv_i) in enumerate(zip(kv.unbind(0),
                                             ukv.unbind(0))):
            outs.append(torch.bmm(rt[t0 + i], S + ukv_i))
            S = wt[t0 + i] * S + kv_i
    out = torch.stack(outs, dim=1)                      # (n, T, 1, V)
    out = out.reshape(B, H, T, hd).permute(0, 2, 1, 3)
    return out, S.reshape(B, H, hd, hd)


def _cols(x: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel projection's input (``comm.copy_to_group``)."""
    return comm.copy_to_group(x, group, "trunk")


def rwkv_time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict,
                  group=None):
    """x (B, T, D), the normed input.  Returns (y, {"wkv", "shift1"});
    on a rank (``group``), y is its heads' share of ``w_o``'s sum."""
    B, T, _ = x.shape
    hd = cfg.rwkv_head_size
    c = width(cfg)
    h = c // hd
    dt = x.dtype
    prev = _shifted(x, state["shift1"])
    xr, xk = _lerp(x, prev, p["mu_r"]), _lerp(x, prev, p["mu_k"])
    xv, xw = _lerp(x, prev, p["mu_v"]), _lerp(x, prev, p["mu_w"])
    xg = _lerp(x, prev, p["mu_g"])
    r = (_cols(xr, group) @ p["w_r"].to(dt)).reshape(B, T, h, hd)
    k = (_cols(xk, group) @ p["w_k"].to(dt)).reshape(B, T, h, hd)
    v = (_cols(xv, group) @ p["w_v"].to(dt)).reshape(B, T, h, hd)
    g = _cols(xg, group) @ p["w_g"].to(dt)
    # data-dependent decay (Finch): w_t = exp(-exp(w0 + lora(xw)))
    lora = _cols((xw @ p["wA"].to(dt)).float(), group)
    dec = p["w0"].float() + lora @ p["wB"].float()
    w = torch.exp(-torch.exp(dec)).reshape(B, T, h, hd)
    u = p["u"].reshape(h, hd).float()
    out, S = wkv_scan(state["wkv"], r.float(), k.float(), v.float(), w, u)
    out = group_norm_heads(out.reshape(B, T, c).to(dt), p["ln_x"], h)
    out = out * F.silu(g)
    return out @ p["w_o"].to(dt), {"wkv": S, "shift1": x[:, -1].float()}


def rwkv_channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     state: dict, group=None):
    """x (B, T, D), the normed input.  Returns (y, {"shift2"}).  With
    ``group`` (a split trunk): ``kv`` summed over the ranks first, its
    columns ``cfg.shard.chan`` times the rank's ``sigmoid(xr @ w_r_cm)``,
    the products all-gathered in rank order -- every rank the whole y."""
    dt = x.dtype
    prev = _shifted(x, state["shift2"])
    xk = _lerp(x, prev, p["mu_k_cm"])
    xr = _lerp(x, prev, p["mu_r_cm"])
    kk = F.relu(_cols(xk, group) @ p["w_k_cm"].to(dt))
    kv = (kk * kk) @ p["w_v_cm"].to(dt)
    r = torch.sigmoid(_cols(xr, group) @ p["w_r_cm"].to(dt))
    if group is None:
        return r * kv, {"shift2": x[:, -1].float()}
    lo, hi = cfg.shard.chan
    kv = comm.sum_to_group(kv, group, "trunk")
    parts = comm.gather_from_group(r * kv[..., lo:hi], group,
                                   "trunk")                  # (W, B, T, c)
    y = parts.permute(1, 2, 0, 3).reshape(x.shape)
    return y, {"shift2": x[:, -1].float()}


def rwkv_block(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict,
               group=None):
    """The whole RWKV layer, pre-norm residual: x (B, T, D) and ``state``
    {"shift1", "shift2", "wkv"} of the B sequences -> (x, the new state).
    T = 1 is a decode step.  With ``group`` (a split trunk) the time-mix
    output is summed over the ranks and the channel-mix gathers its
    own."""
    a, s1 = rwkv_time_mix(p, rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                          state, group)
    x = x + comm.reduce_from_group(a, group, "trunk")
    b, s2 = rwkv_channel_mix(p, rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                             state, group)
    return x + b, {"shift1": s1["shift1"], "shift2": s2["shift2"],
                   "wkv": s1["wkv"]}
