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

with ``"mlp": {"w_in": (L, D, F), "w_out": (L, F, D)}`` for an
activation that is not a GLU (gelu, relu, squared_relu),
so the bridge from JAX is a pure copy and the layer loop indexes ``[l]``.
The hybrid family (recurrentgemma) has one dict per segment of its block
program, each slot an ``attn`` layer as above or a ``rec`` layer,
``{"rec": the RG-LRU block (models.rglru.layer_shapes), "ln2", "mlp"}``;
the ssm family (rwkv6) one segment of one ``rwkv`` slot, the layer's
leaves flat in it (``models.rwkv6.layer_shapes``), beside an untied
``lm_head``.  The moe family's ``moe`` slot has ``"moe"`` in place of
``"mlp"``: ``{"router": (L, D, E), "w_gate", "w_up": (L, E, D, Fe),
"w_out": (L, E, Fe, D)}``, plus ``"shared"``, a dense MLP of width Fe,
where the config has a shared expert; phi3.5-moe is one segment of one
``moe`` slot, llama4-maverick one segment of ``(attn, moe)`` slots.
The vlm family's tree is the dense family's.  The encdec family's
decoder slot is an ``xattn`` layer, an ``attn`` layer plus ``"lnx"``
(D,) and ``"xattn"`` ``{"wq", "wk", "wv", "wo"}`` (cross-attention never
has qk-norm scales), and beside the decoder sit ``"encoder"``, one
segment of one ``enc`` slot (an ``attn`` layer's leaves) over
``n_encoder_layers``, and ``"encoder_norm"`` (D,).
Weights are normal times 1/sqrt(fan-in), zeros for the norm scales
(which the layers apply as ``1 + scale``), drawn on the host from a seed
(``seeded_params``).  The numbers differ from ``jax.random``'s; tests
carry JAX's parameters across with ``from_numpy_params`` instead.
"""
from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru, rwkv6
from repro_torch.parallel import comm, sharding
from repro_torch.tree import map_tree


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype the config names (``"bfloat16"``/``"float32"``)."""
    return getattr(torch, cfg.dtype)


def param_shapes(cfg: ModelConfig) -> dict:
    """The tree of shapes ``seeded_params`` builds, leaf = (shape, init):
    init a fan-in (normal / sqrt(fan_in)), None (zeros, the norm scales
    and biases), one of the RG-LRU's draws (``"conv"``,
    ``"lru_lambda"``; ``models.rglru.layer_shapes``), ``("std", s)``
    (normal * s) or ``("full", c)`` (the constant c; RWKV6's mixing
    coefficients, base decay and ``ln_x``).

    ``decoder`` holds one dict per segment of ``lm.segments`` (its unit
    repeated ``count`` times), each slot's leaves stacked over ``count``,
    as the reference's ``_init_segment`` stacks them: the dense family is
    one segment of one ``attn`` slot over every layer; the hybrid family
    (recurrentgemma) one segment of its pattern repeated, then the
    remainder, e.g. 8 x (rec, rec, attn) + 1 x (rec, rec) at 26 layers;
    the ssm family (rwkv6) one segment of one ``rwkv`` slot; the moe
    family one segment of its ``interleave_step`` unit (``moe`` last),
    whose ``moe`` slot holds the router and the expert stacks
    (reference ``init_moe``); the encdec family one segment of one
    ``xattn`` slot, and ``encoder`` the segments of
    ``lm.encoder_segments`` (reference ``init_params``)."""
    from repro_torch.models import lm

    d, v = cfg.d_model, cfg.vocab_size
    qw, kw, f = cfg.q_width, cfg.kv_width, cfg.d_ff

    def mlp_shapes(L: int, f: int) -> dict:
        if cfg.activation.endswith("_glu"):
            mlp = {"w_gate": ((L, d, f), d), "w_up": ((L, d, f), d)}
        else:
            mlp = {"w_in": ((L, d, f), d)}
        mlp["w_out"] = ((L, f, d), f)
        return mlp

    def attn_shapes(L: int, cross: bool) -> dict:
        attn = {"wq": ((L, d, qw), d), "wk": ((L, d, kw), d),
                "wv": ((L, d, kw), d), "wo": ((L, qw, d), qw)}
        if cfg.qk_norm and not cross:
            attn["q_norm"] = ((L, cfg.head_dim), None)
            attn["k_norm"] = ((L, cfg.head_dim), None)
        return attn

    def layer(kind: str, L: int) -> dict:
        if kind == "rwkv":
            return rwkv6.layer_shapes(cfg, L)
        mlp = mlp_shapes(L, f)
        if kind == "rec":
            return {"rec": rglru.layer_shapes(cfg, L),
                    "ln2": ((L, d), None), "mlp": mlp}
        attn = attn_shapes(L, False)
        if kind != "moe":
            out = {"ln1": ((L, d), None), "attn": attn,
                   "ln2": ((L, d), None), "mlp": mlp}
            if kind == "xattn":
                out["lnx"] = ((L, d), None)
                out["xattn"] = attn_shapes(L, True)
            return out
        m = cfg.moe
        e, fe = m.num_experts, m.d_ff_expert
        moe = {"router": ((L, d, e), d), "w_gate": ((L, e, d, fe), d),
               "w_up": ((L, e, d, fe), d), "w_out": ((L, e, fe, d), fe)}
        if m.shared_expert:
            moe["shared"] = mlp_shapes(L, fe)
        return {"ln1": ((L, d), None), "attn": attn, "ln2": ((L, d), None),
                "moe": moe}

    def stack(segs: list) -> list:
        return [{f"slot{j}": layer(kind, count)
                 for j, kind in enumerate(unit)} for unit, count in segs]

    tree = {"embed": ((v, d), d), "final_norm": ((d,), None),
            "decoder": stack(lm.segments(cfg))}
    if not cfg.tie_embeddings:
        tree["lm_head"] = ((d, v), d)
    if cfg.n_encoder_layers:
        tree["encoder"] = stack(lm.encoder_segments(cfg))
        tree["encoder_norm"] = ((d,), None)
    return tree


def _draw(init, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` values of a leaf whose init is ``init`` (see
    ``param_shapes``), flat f32, from the host ``generator``."""
    if init == "lru_lambda":
        return rglru.lru_lambda((n,), generator)
    w = torch.randn((n,), generator=generator, dtype=torch.float32)
    if isinstance(init, tuple):                  # ("std", s)
        return w.mul_(init[1])
    return w.mul_(0.1 if init == "conv" else 1.0 / math.sqrt(init))


# elements one host generator draws in ``seeded_params``
DRAW_CHUNK = 1 << 22


def _chunk_seed(seed: int, leaf: int, chunk: int) -> int:
    """The host generator seed of chunk ``chunk`` of the ``leaf``-th leaf
    (tree order) under ``seed``."""
    return int(np.random.SeedSequence(
        [seed & (2 ** 64 - 1), leaf, chunk]).generate_state(1, np.uint64)[0])


def seeded_params(cfg: ModelConfig, seed: int, device,
                  dtype: Optional[torch.dtype] = None) -> dict:
    """The one tree a seed names, on ``device``: what the entry points
    (``LLM.from_arch``, the CLI, ``Router.from_arch``, the probe) serve.
    Every leaf is drawn on the HOST, in chunks of ``DRAW_CHUNK``
    consecutive elements, chunk c of the n-th leaf from its own
    ``torch.Generator`` seeded by ``_chunk_seed(seed, n, c)``; the chunks
    are drawn by a pool of threads (an op releases the interpreter lock),
    and each leaf is moved to ``device`` before the next is drawn, so the
    host holds one leaf at a time.  The numbers follow the seed alone:
    one seed gives one tree on the CPU and on the card, under every tp
    and head mode -- a rank cuts its slice from the same host tree.

    With ``dtype`` the f32 masters are never built: each chunk is cast on
    the host as it is drawn, each leaf moved in ``dtype``, and an untied
    ``lm_head`` stored in ``cast_params``' layout -- bit for bit
    ``cast_params(seeded_params(cfg, seed, device), cfg)`` for the
    config's compute dtype, in half the bytes (the host tree of a model
    whose f32 masters and their cast would not fit on one card)."""
    device = torch.device(device)
    n_leaf = iter(range(1 << 62))
    store = torch.float32 if dtype is None else dtype

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        def leaf(path, spec: Tuple[tuple, object]):
            shape, init = spec
            n = next(n_leaf)
            if init is None:
                return torch.zeros(shape, dtype=store, device=device)
            if isinstance(init, tuple) and init[0] == "full":
                return torch.full(shape, float(init[1]), dtype=torch.float32,
                                  device=device).to(store)
            out = torch.empty(shape, dtype=store)
            flat = out.view(-1)

            def fill(c):
                lo = c * DRAW_CHUNK
                hi = min(lo + DRAW_CHUNK, flat.numel())
                g = torch.Generator().manual_seed(_chunk_seed(seed, n, c))
                flat[lo:hi] = _draw(init, hi - lo, g)   # cast as it lands

            list(pool.map(fill, range(-(-flat.numel() // DRAW_CHUNK))))
            out = out.to(device)
            return out if dtype is None else head_layout(path, out)

        return map_tree(leaf, param_shapes(cfg))


def from_numpy_params(tree, cfg: ModelConfig, device) -> dict:
    """The JAX tree as numpy (``jax.tree.map(np.asarray, params)``) ->
    the port's tree on ``device``.  Every leaf is checked against the
    shapes ``seeded_params`` would build; a missing, extra or misshapen
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


def cast_params(params: dict, cfg: ModelConfig,
                dcut: Optional[sharding.DataCut] = None) -> dict:
    """Master weights -> the compute dtype, once at load.

    ``repro.models.lm.cast_params`` does this cast on every step inside
    jit; rounding f32 to bf16 is the same operation either way, so the
    serving port pays it once and keeps only the cast tree.  Training
    (``models.api.train_loss``) casts inside the loss on every step, as
    the reference does: the cast is differentiable, so the gradients
    reach the f32 masters.  Leaves already in the compute dtype are
    returned as they are.

    An untied ``lm_head`` keeps its (D, V) shape but is stored (V, D)
    row-major -- the ``.T`` view of a contiguous (V, D) tensor, the
    layout the head kernel reads, as it reads the tied embedding (a
    head already so stored is not copied again).

    ``dcut`` (a training rank's data cut, FSDP): a data-cut leaf is left
    in f32 as a ``comm.Shard``, which the step casts as it gathers it
    (``comm.gather_shards``), a unit's inside the unit."""
    dt = dtype_of(cfg)

    def leaf(path, a):
        ax = None if dcut is None else dcut.axis(path)
        if ax is not None:
            return comm.Shard(a, ax, dcut.group, dt)
        return head_layout(path, a if a.dtype == dt else a.to(dt))

    return map_tree(leaf, params)


def head_layout(path: tuple, a: torch.Tensor) -> torch.Tensor:
    """An untied ``lm_head`` (D, V) as the ``.T`` view of a row-major
    (V, D) tensor (no copy when it is one already); any other leaf as it
    is."""
    return a.t().contiguous().t() if path == ("lm_head",) else a


def detached(tree):
    """The tree with every tensor leaf ``detach()``-ed (the same storage,
    no autograd history); other leaves as they are."""
    return map_tree(lambda _, a: a.detach() if isinstance(a, torch.Tensor)
                else a, tree)


def shard_params(tree, cfg: ModelConfig, split: Optional[sharding.Split],
                 dcut: Optional[sharding.DataCut] = None) -> dict:
    """The rank's slice of the whole tree under ``split``
    (``sharding.plan``: column/row-parallel trunk by whole heads, the
    recurrent layers by their channels, the vocabulary split along V,
    norms replicated; a split with ``trunk``
    False cuts nothing, the head's vocabulary range is taken from the
    whole tied embedding by ``lm.lm_head_weight``; None cuts nothing),
    then under ``dcut`` its data index's 1/D of every leaf the reference
    cuts over data (``sharding.data_cut``).  ``tree`` is the
    bridged numpy tree or host tensors from ``seeded_params``: the slice is
    cut on the host, before anything goes to the card, and each leaf is
    made contiguous (numpy stays numpy)."""

    def leaf(path, x):
        x = sharding.shard_leaf(path, x, cfg, split, dcut)
        if isinstance(x, torch.Tensor):
            return x.contiguous()
        return np.ascontiguousarray(x)

    return map_tree(leaf, tree)
