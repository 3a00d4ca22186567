"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro.models.rglru``, mirrored op for op (not upstream
Griffin: no sqrt(d) embedding scale; ``jax.nn.gelu``'s tanh
approximation; the gates and the scan in f32; ``sqrt(clip(1 - a^2,
0))``).

Block: rms_norm -> two D -> lru_width projections (x-branch,
gate-branch); the x-branch goes through a causal depthwise conv1d (width
``cfg.conv1d_width``) and the RG-LRU, the gate branch through GeLU; their
product is projected back lru_width -> D and added to the residual.

RG-LRU per channel:
    r_t = sigmoid(x_t @ W_a + b_a)            recurrence gate
    i_t = sigmoid(x_t @ W_i + b_i)            input gate
    a_t = a^(c * r_t),  a = sigmoid(Lambda),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gate projections are head-blocked: ``n_heads`` blocks of (bw, bw).
State per layer and sequence: ``conv`` (w - 1, lru) in the compute
dtype, ``h`` (lru,) f32.  The scan is the reference's ``lax.scan``,
outside any Pallas kernel: here a plain loop over T in the same order of
operations.

Under tensor parallelism (``cfg.shard`` a split trunk, ``group`` its
ranks) the rank's view (``sharding.local_config``) holds its whole gate
blocks: ``lru_width`` its channels and ``n_heads`` its blocks, so the
projections, the conv, the gates, the scan and the state are the rank's
channels alone; ``w_out``'s rows give a partial sum, all-reduced before
the residual.  In training both collectives carry their derivative: the
normed input of ``w_gate_in`` and ``w_x`` goes through
``comm.copy_to_group`` (so the block norm's gradient is whole on every
rank) and the output through ``comm.reduce_from_group``; the gate blocks
are whole on a rank, so ``w_a`` / ``w_i`` need no sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rms_norm
from repro_torch.parallel import comm

C = 8.0
MIN_RAD, MAX_RAD = 0.9, 0.999


def layer_shapes(cfg: ModelConfig, L: int) -> dict:
    """The block's leaves stacked over ``L`` layers, as
    ``weights.param_shapes`` lists them: (shape, init), init a fan-in
    (normal / sqrt(fan_in)), None (zeros), ``"conv"`` (normal * 0.1) or
    ``"lru_lambda"`` (``lru_lambda``)."""
    d, lw = cfg.d_model, cfg.lru_width or cfg.d_model
    nb = cfg.n_heads
    bw = lw // nb
    return {
        "ln": ((L, d), None),
        "w_x": ((L, d, lw), d),
        "w_gate_in": ((L, d, lw), d),
        "conv_w": ((L, cfg.conv1d_width, lw), "conv"),
        "conv_b": ((L, lw), None),
        "w_a": ((L, nb, bw, bw), bw),
        "b_a": ((L, lw), None),
        "w_i": ((L, nb, bw, bw), bw),
        "b_i": ((L, lw), None),
        "lam": ((L, lw), "lru_lambda"),
        "w_out": ((L, lw, d), lw),
    }


def lru_lambda(shape, generator: torch.Generator) -> torch.Tensor:
    """Lambda = logit(a^(1/c)) with a = sqrt(u), u ~ U[0.9^2, 0.999^2):
    the reference's init, a in [0.9, 0.999]."""
    lo, hi = MIN_RAD ** 2, MAX_RAD ** 2
    u = torch.rand(shape, generator=generator,
                   dtype=torch.float32) * (hi - lo) + lo
    a = torch.sqrt(u) ** (1.0 / C)
    return torch.log(a / (1.0 - a))


def init_state(cfg: ModelConfig, lead: tuple, dtype, device) -> dict:
    """A fresh state with leading axes ``lead`` (a batch, or (layers,
    batch)): ``conv`` (*lead, w - 1, lru) in ``dtype`` and ``h`` (*lead,
    lru) f32, zeros."""
    lw = cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((*lead, cfg.conv1d_width - 1, lw),
                                dtype=dtype, device=device),
            "h": torch.zeros((*lead, lw), dtype=torch.float32,
                             device=device)}


def block_proj(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Block-diagonal projection: x (..., nb * bw), w (nb, bw, bw)."""
    nb, bw, _ = w.shape
    xs = x.reshape(*x.shape[:-1], nb, bw)
    y = torch.einsum("...nb,nbc->...nc", xs, w.to(x.dtype))
    return y.reshape(x.shape) + b.to(x.dtype)


def causal_conv1d(x: torch.Tensor, state: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor):
    """Depthwise causal conv: x (B, T, C), state (B, w - 1, C) -- the
    last w - 1 inputs before x --, w (w, C).  Returns (out, new state)."""
    width = w.shape[0]
    full = torch.cat([state.to(x.dtype), x], dim=1)
    T = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(width):
        out = out + full[:, i:i + T] * w[width - 1 - i][None, None].to(
            x.dtype)
    new_state = full[:, -(width - 1):].to(state.dtype) if width > 1 \
        else state
    return out + b.to(x.dtype), new_state


def rglru_scan(x: torch.Tensor, h0: torch.Tensor, a: torch.Tensor,
               i: torch.Tensor):
    """h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t) over T, in f32:
    x, a, i (B, T, C), h0 (B, C).  Returns (hs (B, T, C), h_T)."""
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0)) * (i * x)
    h, hs = h0, []
    for t in range(x.shape[1]):
        h = a[:, t] * h + gated[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_block(p: dict, x: torch.Tensor, cfg: ModelConfig, state: dict,
                group=None):
    """The Griffin recurrent block, in place of attention: x (B, T, D)
    and ``state`` {"conv", "h"} of the B sequences -> (x + y, the new
    state).  T = 1 is a decode step.  With ``group`` (a split trunk) y is
    summed over the ranks."""
    dt = x.dtype
    xn = comm.copy_to_group(rms_norm(x, p["ln"], cfg.norm_eps), group,
                            "trunk")
    gate = F.gelu(xn @ p["w_gate_in"].to(dt), approximate="tanh")
    xb = xn @ p["w_x"].to(dt)
    xb, conv = causal_conv1d(xb, state["conv"], p["conv_w"], p["conv_b"])
    xb32 = xb.float()
    r = torch.sigmoid(block_proj(xb32, p["w_a"].float(), p["b_a"]))
    i = torch.sigmoid(block_proj(xb32, p["w_i"].float(), p["b_i"]))
    # jax.nn.softplus is logaddexp(x, 0)
    sp = torch.logaddexp(p["lam"].float(), torch.zeros((), device=x.device))
    a = torch.exp(-C * r * sp)
    hs, h_last = rglru_scan(xb32, state["h"], a, i)
    y = (hs.to(dt) * gate) @ p["w_out"].to(dt)
    y = comm.reduce_from_group(y, group, "trunk")
    return x + y, {"conv": conv, "h": h_last}

