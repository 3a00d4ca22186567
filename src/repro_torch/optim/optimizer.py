"""AdamW over the port's param tree, the reference's semantics step for
step (``repro.optim.optimizer``).

  - global-norm gradient clipping first, the norm's per-leaf squares
    summed in the tree's leaf order (``repro_torch.tree``), as the
    reference sums them;
  - weight decay on leaves of ``ndim >= 2`` only, judged on the STACKED
    leaf (the port keeps JAX's stacked layout, so a stacked (L, D) norm
    scale is decayed, as in the reference);
  - an optional Adafactor-style factored second moment (a stacked leaf
    whose last two axes are >= 2 is factored over them);
  - optional bf16 moments;
  - linear warmup + cosine decay, and the bias corrections ``1 - b**step``,
    in f32.

On a mesh whose model axis splits the leaves (``update(..., model=,
split_leaf=)``) or whose data axis cuts them (FSDP, ``update(...,
data=, data_axis=)``): the moments are cut as the masters are (the
reference's ``opt_state_specs``), the update is elementwise, and the
global norm is the square root of each leaf's squares summed over the
groups that cut it (the model group's split leaves, the data group's
cut ones, both for a leaf both cut) plus each replicated leaf's
squares, counted once -- the unsharded norm, in another order of the
sum.  ``factored`` refuses a model split (its row and column means run
along axes a split may cut); under a data cut the row and column means
and the rank-1 value's mean that run along the cut axis sum their
parts over the data group (kind ``"opt"``), as the reference's GSPMD
computes them.

This is not ``torch.optim.AdamW``, which decays every leaf, does not
clip and has neither option.  The functions are functional over trees,
except ``update``, which writes the params and the state IN PLACE
under ``torch.no_grad()``.  State: ``{"m": tree, "v": tree (a factored
leaf's entry ``{"vr", "vc"}``), "step": int32 scalar}`` -- the
reference's tree, so checkpoints of either package restore in the other.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch import tree as tree_mod


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    factored: bool = False          # Adafactor-style factored 2nd moment
    state_dtype: str = "float32"    # 'float32' | 'bfloat16' moments


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio * lr; f32 scalar."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(1.0, cfg.warmup_steps), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree, *, model=None, split_leaf=None, skip_leaf=None,
                data=None, data_axis=None) -> torch.Tensor:
    """sqrt of the f32 sum of every leaf's squares, summed leaf after leaf
    in the tree's order.  With ``model`` (a model group) and
    ``split_leaf(path)`` (whether the leaf at ``path`` is a rank's
    slice): the split leaves' sum all-reduced over the group (kind
    ``"norm"``, 4 bytes), plus the replicated leaves' sum, once;
    ``skip_leaf(path)``: a split leaf this rank leaves out, a copy
    another rank of the group counts.  With ``data`` (a data group) and
    ``data_axis(path)`` (the axis it cuts the leaf along, or None): the
    cut leaves' sums all-reduced over the data group first (kind
    ``"norm"``: the leaves cut over data alone, and, under ``model``,
    those cut over both, which then join the model group's sum)."""
    # [model and data cut, model cut, data cut, neither]
    parts = [None] * 4
    for path, leaf in tree_mod.items(tree):
        if model is not None and skip_leaf is not None \
                and skip_leaf(path):
            continue
        s = torch.sum(torch.square(leaf.float()))
        m = model is not None and split_leaf(path)
        d = data is not None and data_axis(path) is not None
        i = (0 if d else 1) if m else (2 if d else 3)
        parts[i] = s if parts[i] is None else parts[i] + s
    if data is not None:
        dev = tree_mod.leaves(tree)[0].device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        cut = [parts[2]] if model is None else [parts[0], parts[2]]
        cut = data.all_reduce_sum(torch.stack(
            [zero if p is None else p for p in cut]), "norm")
        parts[2] = cut[-1]
        if model is not None:
            parts[0] = cut[0]
    split = parts[1] if parts[0] is None else (
        parts[0] if parts[1] is None else parts[0] + parts[1])
    total = parts[3]
    if split is not None:
        split = model.all_reduce_sum(split.reshape(1), "norm")[0]
        total = split if total is None else total + split
    if parts[2] is not None:
        total = parts[2] if total is None else total + parts[2]
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, the norm
    before)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_mod.map_tree(lambda _, g: g * scale.to(g.dtype), tree), norm


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def _is_factored(v) -> bool:
    return isinstance(v, dict) and set(v) == {"vr", "vc"}


def init_state(cfg: AdamWConfig, params) -> dict:
    """Zero moments on each leaf's device: ``{"m", "v", "step"}``."""
    sdt = getattr(torch, cfg.state_dtype)

    def mk_m(_, p):
        return torch.zeros(p.shape, dtype=sdt, device=p.device)

    def mk_v(_, p):
        if cfg.factored and _factorable(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=sdt, device=p.device)

    dev = tree_mod.leaves(params)[0].device
    return {"m": tree_mod.map_tree(mk_m, params),
            "v": tree_mod.map_tree(mk_v, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _mean(x: torch.Tensor, dim: int, cut, keepdim: bool = False):
    """``x.mean(dim)``; where ``cut`` (a data group, the axis it cuts,
    negative) cuts ``dim``, the mean over the whole axis: the rank's sum
    all-reduced over the group (kind ``"opt"``), over the whole count."""
    if cut is None or cut[1] != dim:
        return x.mean(dim=dim, keepdim=keepdim)
    group = cut[0]
    s = group.all_reduce_sum(x.sum(dim=dim, keepdim=keepdim), "opt")
    return s / (x.shape[dim] * group.world)


def _second_moment_update(cfg: AdamWConfig, v, g2, cut=None):
    if _is_factored(v):
        return {"vr": cfg.b2 * v["vr"] + (1 - cfg.b2) * _mean(g2, -1, cut),
                "vc": cfg.b2 * v["vc"] + (1 - cfg.b2) * _mean(g2, -2, cut)}
    return (cfg.b2 * v.float() + (1 - cfg.b2) * g2).to(v.dtype)


def _second_moment_value(v, cut=None) -> torch.Tensor:
    if _is_factored(v):              # the rank-1 estimate
        vr, vc = v["vr"], v["vc"]
        # vr's last axis is the leaf's second-to-last
        rcut = (cut[0], -1) if cut is not None and cut[1] == -2 else None
        denom = torch.clamp(_mean(vr, -1, rcut, keepdim=True), min=1e-30)
        return vr[..., None] * vc[..., None, :] / denom[..., None]
    return v.float()


def check_split(cfg: AdamWConfig, split: bool) -> None:
    """Refuse ``factored`` where the leaves are split over a model axis:
    its second moment's row and column means run along the axes the
    split cuts (a column-parallel leaf's rows, a row-parallel one's
    columns, the embedding's vocabulary), and its rank-1 value divides by
    a mean over them."""
    if cfg.factored and split:
        raise ValueError("factored=True under a split model axis: its row "
                         "and column means run along axes the split cuts; "
                         "train it on a mesh of model 1")


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params, *, model=None,
           split_leaf=None, skip_leaf=None, data=None,
           data_axis=None) -> dict:
    """One AdamW step: ``params`` and ``state`` are written in place (the
    reference returns new trees; the numbers are the same).  Returns the
    metrics ``{"grad_norm", "lr"}`` (f32 scalars on the device).
    ``model`` / ``split_leaf`` / ``skip_leaf``: a rank's slices over its
    model group; ``data`` / ``data_axis``: its cuts over its data group
    (``global_norm``, and a factored leaf's means).  Each leaf is
    updated UPDATE_CHUNK elements of its flat view at a time
    (``_chunks``, ``_update_leaf``)."""
    check_split(cfg, model is not None)
    gnorm = global_norm(grads, model=model, split_leaf=split_leaf,
                        skip_leaf=skip_leaf, data=data, data_axis=data_axis)
    scale = (_clip_scale(gnorm, cfg.clip_norm)
             if cfg.clip_norm is not None else None)
    step = state["step"].add_(1)
    lr = schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    for path, g in tree_mod.items(grads):
        p = tree_mod.get(params, path)
        m = tree_mod.get(state["m"], path)
        v = tree_mod.get(state["v"], path)
        decay = bool(cfg.weight_decay) and p.dim() >= 2  # matrices only
        ax = None if data is None else data_axis(path)
        cut = None if ax is None else (data, ax - p.dim())
        for part in _chunks(g, m, v, p):
            _update_leaf(cfg, *part, scale, lr, b1c, b2c, decay, cut)
    return {"grad_norm": gnorm, "lr": lr}


# elements of a leaf updated at once: a leaf is updated a chunk of its
# flat view at a time, so the update's f32 temporaries stay a few times
# this size -- elementwise, the same bits as the whole leaf at once
UPDATE_CHUNK = 1 << 26


def _chunks(g, m, v, p) -> list:
    """(g, m, v, p) as consecutive UPDATE_CHUNK-element pieces of their
    flat views (a smaller leaf is one piece); whole where the second
    moment is factored (its row and column factors span the leaf) or a
    tensor is not contiguous (no flat view writes through to it)."""
    if _is_factored(v) or not all(t.is_contiguous() for t in (g, m, v, p)):
        return [(g, m, v, p)]
    flat = [t.view(-1) for t in (g, m, v, p)]
    return [tuple(t[lo:lo + UPDATE_CHUNK] for t in flat)
            for lo in range(0, max(g.numel(), 1), UPDATE_CHUNK)]


def _update_leaf(cfg: AdamWConfig, g, m, v, p, scale, lr, b1c, b2c,
                 decay: bool, cut=None) -> None:
    """AdamW on one leaf (or one chunk of its flat view), in place on
    ``p``, ``m`` and ``v``; ``cut`` (the data group, the axis it cuts the
    leaf along, negative) reaches a factored second moment's means."""
    if scale is not None:
        g = g * scale.to(g.dtype)
    g32 = g.float()
    m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g32
    v2 = _second_moment_update(cfg, v, g32 * g32, cut)
    del g, g32
    # the same roundings as the reference's out-of-place expression,
    # in place on this leaf's temporaries
    den = (_second_moment_value(v2, cut) / b2c).sqrt_().add_(cfg.eps)
    upd = (m2 / b1c).div_(den)
    del den
    if decay:
        upd.add_(cfg.weight_decay * p.float())
    p.copy_(p.float() - lr * upd)
    del upd
    m.copy_(m2)
    if _is_factored(v):
        v["vr"].copy_(v2["vr"])
        v["vc"].copy_(v2["vc"])
    else:
        v.copy_(v2)
