"""Parameters of the port: seeded init, the numpy bridge, and the cast.

The tree keeps the JAX package's stacked layout (``repro.models.lm``):

    {"embed": (V, D), "final_norm": (D,),
     "decoder": [{"slot0": {"ln1": (L, D), "ln2": (L, D),
                            "attn": {"wq": (L, D, Hq*hd), "wk": (L, D, Hkv*hd),
                                     "wv": (L, D, Hkv*hd), "wo": (L, Hq*hd, D),
                                     "q_norm": (L, hd), "k_norm": (L, hd)},
                            "mlp": {"w_gate": (L, D, F), "w_up": (L, D, F),
                                    "w_out": (L, F, D)}}}],
     "lm_head": (D, V)}                       # only when not tied

so the bridge from JAX is a pure copy and the layer loop indexes ``[l]``.
Weights are drawn from an explicit ``torch.Generator``: normal times
1/sqrt(fan-in), zeros for the norm scales (which the layers apply as
``1 + scale``).  The numbers differ from ``jax.random``'s; tests carry
JAX's parameters across with ``from_numpy_params`` instead.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype the config names (``"bfloat16"``/``"float32"``)."""
    return getattr(torch, cfg.dtype)


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree of shapes ``init_params`` builds, leaf = (shape, fan_in);
    fan_in None marks a norm scale (zero init)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: the port serves the dense family only")
    d, v, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    qw, kw, f = cfg.q_width, cfg.kv_width, cfg.d_ff
    if not cfg.activation.endswith("_glu"):
        raise NotImplementedError(
            f"activation {cfg.activation!r}: the port has the GLU MLP only")
    attn = {"wq": ((L, d, qw), d), "wk": ((L, d, kw), d),
            "wv": ((L, d, kw), d), "wo": ((L, qw, d), qw)}
    if cfg.qk_norm:
        attn["q_norm"] = ((L, cfg.head_dim), None)
        attn["k_norm"] = ((L, cfg.head_dim), None)
    layer = {
        "ln1": ((L, d), None),
        "attn": attn,
        "ln2": ((L, d), None),
        "mlp": {"w_gate": ((L, d, f), d), "w_up": ((L, d, f), d),
                "w_out": ((L, f, d), f)},
    }
    tree = {"embed": ((v, d), d), "final_norm": ((d,), None),
            "decoder": [{"slot0": layer}]}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, v), d)
    return tree


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> dict:
    """Seeded float32 master weights, same tree, shapes and scales as
    ``repro.models.lm.init_params``.  ``generator`` must live on
    ``device`` (``torch.Generator(device=...)``)."""
    device = torch.device(device)

    def leaf(path, spec: Tuple[tuple, int]):
        shape, fan_in = spec
        if fan_in is None:
            return torch.zeros(shape, dtype=torch.float32, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(1.0 / math.sqrt(fan_in))

    return _map(leaf, param_shapes(cfg))


def from_numpy_params(tree, cfg: ModelConfig, device) -> dict:
    """The JAX tree as numpy (``jax.tree.map(np.asarray, params)``) ->
    the port's tree on ``device``.  Every leaf is checked against the
    shapes ``init_params`` would build; a missing, extra or misshapen
    leaf raises."""
    device = torch.device(device)
    want = param_shapes(cfg)

    def check(w, t, path):
        if isinstance(w, dict):
            if not isinstance(t, dict) or set(t) != set(w):
                raise ValueError(f"param tree at {path}: keys "
                                 f"{sorted(t) if isinstance(t, dict) else t!r}"
                                 f" != {sorted(w)}")
            return {k: check(w[k], t[k], path + (k,)) for k in w}
        if isinstance(w, list):
            if not isinstance(t, (list, tuple)) or len(t) != len(w):
                raise ValueError(f"param tree at {path}: expected a list of "
                                 f"{len(w)}")
            return [check(a, b, path + (i,)) for i, (a, b) in
                    enumerate(zip(w, t))]
        arr = np.asarray(t)
        if arr.shape != tuple(w[0]):
            raise ValueError(f"param {path}: shape {arr.shape} != {w[0]}")
        if arr.dtype not in (np.float32, np.float16, np.float64):
            raise ValueError(f"param {path}: dtype {arr.dtype} not supported "
                             "(pass float32 master weights)")
        return torch.from_numpy(np.array(arr, np.float32)).to(device)

    return check(want, tree, ())


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """Master weights -> the compute dtype, once at load.

    ``repro.models.lm.cast_params`` does this cast on every step inside
    jit; rounding f32 to bf16 is the same operation either way, so the
    port pays it once and keeps only the cast tree.  Leaves already in
    the compute dtype are returned as they are.

    An untied ``lm_head`` keeps its (D, V) shape but is stored (V, D)
    row-major -- the ``.T`` view of a contiguous (V, D) tensor, the
    layout the head kernel reads, as it reads the tied embedding."""
    dt = dtype_of(cfg)

    def leaf(path, a):
        a = a if a.dtype == dt else a.to(dt)
        if path == ("lm_head",):
            a = a.t().contiguous().t()
        return a

    return _map(leaf, params)

