"""The tensor-parallel split of the param trees of every family: dense,
vlm, moe, hybrid (RG-LRU), ssm (RWKV6) and encdec (trained, and run
through ``lm.prefill`` / ``lm.decode_step``; the engine serves no
encoder-decoder config).

Counterpart of ``repro.parallel.sharding`` (``_PARAM_RULES`` :26-44,
``_MOE_RULES`` :49-54, ``param_specs`` :75-113, ``paged_pool_specs``
:142-163, the recurrent states' ``_CACHE_BASE`` :186-197) for serving:

  column-parallel   wq, wk, wv, w_gate, w_up, w_in (their output columns)
  row-parallel      wo, w_out (their input rows; an all-reduce follows)
  experts           a ``moe`` layer's expert stacks w_gate / w_up / w_out
                    (E, ...), split along E into contiguous rank-ordered
                    ranges (expert parallelism, ``repro.parallel.moe_ep``)
  vocabulary        the embedding (V, D) and an untied lm_head (D, V),
                    split along V into contiguous rank-ordered ranges
  replicated        the norms (ln1, ln2, lnx, final_norm, encoder_norm,
                    q_norm, k_norm) and the router
  encdec            the encoder's ``enc`` layers and each ``xattn``
                    layer's cross-attention by the same names: wq / wk /
                    wv by heads, wo by rows
  rwkv6             by whole heads (``Split.chan``, the rank's heads' hd
                    columns): w_r, w_k, w_v, w_g and the channel-mix's
                    w_r_cm by columns, w0, u, ln_x and the decay LoRA's
                    wB by channel, w_o by rows (an all-reduce follows);
                    the channel-mix's w_k_cm by its d_ff columns, w_v_cm
                    by those rows; wA and the mu_* mixing coefficients
                    replicated (they read the full-width input)
  rg-lru            by whole gate blocks (``Split.chan``: the rank's
                    blocks of lru_width / n_heads channels, the blocks
                    its q heads number): w_x, w_gate_in by columns,
                    conv_w, conv_b, b_a, b_i, lam by channel, the block
                    stacks w_a / w_i (nb, bw, bw) by block, the block's
                    w_out by rows (an all-reduce follows)

A leaf's rule follows its path, not its name alone: under ``moe`` (and
not under ``shared``) the expert stacks, whose names are the dense MLP's,
split along E; ``moe/shared/*`` splits like ``mlp/*``, at the shared
expert's width; ``rec/w_out`` splits by the lru channels and
``mlp/w_out`` by the MLP's.  Every rank routes every token over all E
experts with the global capacity (``local_config`` keeps ``cfg.moe``
whole), computes its own experts' kept slots and its part of the shared
expert, and one all-reduce sums the ranks' shares -- the dense MLP's
bytes.

The recurrent states split as their weights: an RG-LRU layer's ``conv``
and ``h`` hold the rank's lru channels, an RWKV6 layer's ``wkv`` its
heads, and the token shifts ``shift1`` / ``shift2`` stay full width (the
same values on every rank).  The RWKV6 channel-mix ``sigmoid(xr @ w_r_cm)
* kv`` needs the whole ``kv = sum_ranks (kk * kk) @ w_v_cm[rows]``
before its product, so it runs all-reduce ``kv``, take the rank's
columns, multiply by the rank's ``sigmoid(r)`` columns, all-gather the
product (``models.rwkv6.rwkv_channel_mix``).

Heads are split WHOLE.  The q heads must divide by the world size.  The
kv heads are split when they divide too; otherwise every rank keeps a
copy of the kv heads its q heads read (each rank's q heads must then
read one kv head, or whole kv groups), and its paged pool holds those:
recurrentgemma-2b's one MQA kv head is copied to every rank.  The
reference's GSPMD rule divides columns instead, which at smoke size
and tp 4 cuts ``wk`` (64, 32) into half heads; the whole-head rule gives
the same tokens (``tests/test_torch_tp.py``).  The vocabulary must divide
too when serving: the sharded head cuts V into equal slices, as the
reference's ``shard_map`` with ``P(None, 'model')`` on W does, so
internvl2-26b (V 92,553 = 3 x 30,851) is served at tp 1 only, in both
packages.  Training keeps such a vocabulary whole on every rank
(``plan(whole_vocab=True)``), as the reference's ``param_specs`` drops a
mesh axis that does not divide a leaf's dimension and holds the leaf
whole (``repro/parallel/sharding.py:101-110``): the embedding, an untied
head and the loss are then each rank's whole ones (``vocab_cut``).

The reference's fallback to the training layout for a model that does
not fit once sharded (``serve_param_specs`` :116-139) is not ported:
``plan`` raises with the per-rank bytes instead.

Training on a (data, model) mesh of D x M ranks (``train_plan``; the
reference's ``param_specs`` / ``opt_state_specs`` :75-113, 231-256 and
``batch_specs`` :177-200): the model axis takes the serve split above,
applied to the f32 masters, their gradients and AdamW's ``m`` / ``v``
alike (``shard_params`` cuts a whole train state: ``leaf_cut`` reads the
leaf's path, which ``split_axis`` and ``gather_tree`` read too); the data
axis cuts the batch into D contiguous row blocks, and the weights as
below (FSDP).
Every family trains under M > 1; a vocabulary that does not divide by M
stays whole on every rank.  A kv head that does not divide by M is
copied to the ranks whose q heads read it (``kv_copies``): each copy's
wk / wv gradient is that rank's q heads' part, summed over the ranks
holding the copy in the step (an encoder's and a cross-attention's
too).  ``gather_tree`` puts a rank's slices back into the
whole layout, over the data group and then the model group;
``gather_to_host`` puts them together on rank 0's host alone, leaf by
leaf (a checkpoint).

At D > 1 the data axis cuts the weights too (FSDP, the reference's
``_COL`` / ``_ROW`` :24-25): every leaf the reference's ``param_specs``
cuts over ``"data"`` (``data_axis``: its ``_PARAM_RULES`` /
``_MOE_RULES`` data position after the leading stack axes, dropped
where the whole dimension does not divide by D, :101-110) is held by
each rank as its 1/D cut along that axis (``data_cut``), on top of its
model cut -- the f32 masters, their gradients and AdamW's moments alike
(a factored moment keeps the cut of the axis it does not reduce, as
``opt_state_specs`` :231-255).  The reference's specs never give
"data" and "model" one dimension; the port's own model cut of RWKV6's
``wB`` (by channel, which the reference leaves whole over "model") is
the one leaf whose data axis it also cuts, and there the data cut is
taken within the rank's channels.  A vocabulary kept whole over the
model axis still has its D dimension cut over data, as the reference's
``("model", "data")`` with its model axis dropped.  The step gathers a
data-cut leaf as it reads it (``comm.gather_shards``) and
reduce-scatters its gradient; the reference's ``seq_parallel_attn``
rule (:93-94) moves only attention's model axis, so its data positions
are those of ``_COL`` / ``_ROW``.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

from repro_torch import tree as tree_mod
from repro_torch.configs.base import ModelConfig

_COL = ("wq", "wk", "wv", "w_gate", "w_up", "w_in")
_ROW = ("wo", "w_out")
# rwkv6 leaves cut along their last axis to the rank's channels, and
# w_o along its rows
_RWKV_CHAN = ("w_r", "w_k", "w_v", "w_g", "w_r_cm", "w0", "u", "ln_x", "wB")
# an rg-lru block's leaves cut along their last axis to the rank's lru
# channels (w_a / w_i by block, w_out by rows)
_REC_CHAN = ("w_x", "w_gate_in", "conv_w", "conv_b", "b_a", "b_i", "lam")


@dataclasses.dataclass(frozen=True)
class Split:
    """One rank's cut of a model: half-open ranges of q heads, kv heads,
    MLP columns and vocabulary ids, for the moe family of experts and of
    the shared expert's columns, and for the recurrent families of
    ``chan``, the recurrent layers' channels (an RG-LRU block's lru
    channels, an RWKV6 layer's heads' hd columns); ``trunk`` False keeps
    the trunk whole (only the head's vocabulary is split).  ``group``,
    the ranks the cut is shared over, rides along once the split is the
    rank's (``local_config`` puts it on the rank's cfg as ``cfg.shard``,
    where ``lm``, the recurrent blocks and the samplers read it)."""

    rank: int
    world: int
    trunk: bool
    q: Tuple[int, int]
    kv: Tuple[int, int]
    ff: Tuple[int, int]
    vocab: Tuple[int, int]
    experts: Tuple[int, int] = (0, 0)
    fe: Tuple[int, int] = (0, 0)
    chan: Tuple[int, int] = (0, 0)
    group: Any = dataclasses.field(default=None, compare=False, repr=False)


def _even(n: int, world: int, rank: int, what: str,
          why: str = "") -> Tuple[int, int]:
    if n % world:
        raise ValueError(f"{what}={n} does not divide by the world size "
                         f"{world}{why}")
    per = n // world
    return rank * per, (rank + 1) * per


def _chan_width(cfg: ModelConfig) -> int:
    """The recurrent layers' width: lru_width (RG-LRU), D (RWKV6), 0."""
    if cfg.family == "hybrid":
        return cfg.lru_width or cfg.d_model
    return cfg.d_model if cfg.family == "ssm" else 0


def plan(cfg: ModelConfig, rank: int, world: int, *, trunk: bool = True,
         max_bytes_per_rank: Optional[float] = None, group=None,
         whole_vocab: bool = False) -> Split:
    """Rank ``rank``'s share of ``cfg`` among ``world`` ranks (of
    ``group``, where there is one).  Raises
    ``ValueError`` where the q heads (an RWKV6 config's time-mix heads;
    a hybrid config's, which number its RG-LRU gate blocks too), the MLP
    width, the experts, the shared expert's width or the vocabulary do
    not divide by ``world``, where a rank's q heads would read part of a
    kv group, or where a rank's compute-dtype weights exceed
    ``max_bytes_per_rank``.  ``whole_vocab`` (training): a vocabulary
    that does not divide by ``world`` is held whole, ``vocab`` (0, V),
    on every rank instead of refused -- the reference's ``param_specs``
    drops an axis that does not divide a leaf's dimension
    (``repro/parallel/sharding.py:101-110``); serving's sharded head
    cuts equal slices and refuses it."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if whole_vocab and cfg.vocab_size % world:
        vocab = (0, cfg.vocab_size)
    else:
        vocab = _even(cfg.vocab_size, world, rank, "vocab_size",
                      ": the sharded head cuts V into equal slices (the "
                      "reference's shard_map with P(None, 'model') on W "
                      "refuses it too)")
    m = cfg.moe
    width = _chan_width(cfg)
    if not trunk:
        return Split(rank, world, False, (0, cfg.n_heads),
                     (0, cfg.n_kv_heads), (0, cfg.d_ff), vocab,
                     (0, m.num_experts) if m else (0, 0),
                     (0, m.d_ff_expert) if m else (0, 0), (0, width), group)
    if cfg.family == "ssm":
        # an RWKV6 layer's time-mix heads, rwkv_head_size channels each
        heads = cfg.d_model // cfg.rwkv_head_size
        q = kv = _even(heads, world, rank, "rwkv heads (d_model / "
                       "rwkv_head_size)")
    else:
        heads, why = cfg.n_heads, ""
        if cfg.family == "hybrid":
            why = (f": whole heads a rank, and the RG-LRU's {heads} gate "
                   f"blocks of {width // heads} channels with them")
        q = _even(heads, world, rank, "n_heads", why)
        kv = _kv_range(cfg, q, world, rank)
    per = width // heads                  # channels a head (or block)
    chan = (q[0] * per, q[1] * per)
    ff = _even(cfg.d_ff, world, rank, "d_ff")
    experts = fe = (0, 0)
    if m is not None:
        experts = _even(m.num_experts, world, rank, "num_experts")
        fe = _even(m.d_ff_expert, world, rank, "d_ff_expert")
    split = Split(rank, world, True, q, kv, ff, vocab, experts, fe, chan,
                  group)
    if max_bytes_per_rank is not None:
        need = rank_param_count(cfg, split) * (
            2 if cfg.dtype == "bfloat16" else 4)
        if need > max_bytes_per_rank:
            raise ValueError(
                f"{cfg.name} at world {world}: {need / 1e9:.2f} GB of "
                f"weights a rank, more than {max_bytes_per_rank / 1e9:.2f}; "
                "the training layout's fallback is not ported")
    return split


def _kv_range(cfg: ModelConfig, q: Tuple[int, int], world: int,
              rank: int) -> Tuple[int, int]:
    """The kv heads rank ``rank`` holds for its q heads ``q``: its even
    range where they divide by ``world``, else a copy of the kv heads
    its q heads read -- valid when they read one kv head, or whole kv
    groups."""
    if cfg.n_kv_heads % world == 0:
        return _even(cfg.n_kv_heads, world, rank, "n_kv_heads")
    per_kv = cfg.n_heads // cfg.n_kv_heads        # q heads per kv head
    kv = (q[0] // per_kv, (q[1] - 1) // per_kv + 1)
    whole = q[0] % per_kv == 0 and (q[1] - q[0]) % per_kv == 0
    if not (whole or kv[1] - kv[0] == 1):
        raise ValueError(
            f"n_heads={cfg.n_heads}, n_kv_heads={cfg.n_kv_heads} at "
            f"world {world}: rank {rank}'s q heads {q} read part of a "
            "kv group; whole heads cannot be split so")
    return kv


def local_config(cfg: ModelConfig, split: Split) -> ModelConfig:
    """The rank's view of ``cfg``: its q heads, kv heads and MLP width,
    a hybrid config's ``lru_width`` its lru channels (``n_heads`` then
    numbers its gate blocks too), and ``shard`` the split itself, where
    an RWKV6 layer reads its heads (``models.rwkv6.width``; ``d_model``
    stays the residual width); what the layers, the caches, the
    recurrent states and the pools are built at.  ``vocab_size`` stays
    whole, the rank's ids are ``split.vocab``, and ``moe`` stays whole
    too: the router's E columns and the capacity ``ceil(cf * N * k /
    E)`` are over all the experts (a rank that shrank E would drop other
    tokens), the rank's experts are ``split.experts``."""
    if not split.trunk:
        return dataclasses.replace(cfg, shard=split)
    kw = dict(n_heads=split.q[1] - split.q[0],
              n_kv_heads=split.kv[1] - split.kv[0],
              d_ff=split.ff[1] - split.ff[0], shard=split)
    if cfg.family == "hybrid":
        kw["lru_width"] = split.chan[1] - split.chan[0]
    return dataclasses.replace(cfg, **kw)


def rank_param_count(cfg: ModelConfig, split: Optional[Split],
                     dcut: Optional["DataCut"] = None) -> int:
    """Parameters a rank holds under ``split`` (None: the model axis
    whole) and ``dcut`` (None: the data axis whole): every leaf of
    ``weights.param_shapes`` at the shape ``rank_shape`` cuts it to --
    a ``moe`` layer's experts (always three (d, Fe) matrices, as the
    reference's ``init_moe``) by E, the recurrent layers by their
    channels, the vocabulary slice (the whole vocabulary where it is
    kept whole), and under ``dcut`` each data-cut leaf's 1/D."""
    return sum(math.prod(rank_shape(path, shape, cfg, split, dcut))
               for path, (shape, _) in tree_mod.items(_whole_shapes(cfg)))


def leaf_cut(path: tuple, cfg: ModelConfig,
             split: Split) -> Optional[Tuple[int, int, int]]:
    """(axis, lo, hi): where rank ``split.rank`` cuts the leaf at ``path``
    (of a param tree or a train state: the rule reads the path, not its
    last key alone), or None for a leaf it holds whole.  A ``moe`` layer's
    expert stacks (L, E, ...) split along their expert axis, its shared
    expert like a dense MLP at its own width, its router not at all; a
    ``rec`` block's leaves by its lru channels (``w_a`` / ``w_i`` by gate
    block, its ``w_out`` by rows); an ``rwkv`` layer's by its heads'
    channels (the channel-mix's ``w_k_cm`` / ``w_v_cm`` by the MLP's)."""
    key = path[-1] if path else None
    hd = cfg.head_dim
    if key in ("embed", "lm_head"):
        if not split.trunk or split.vocab == (0, cfg.vocab_size):
            return None                       # the head-only or whole V
        return (0 if key == "embed" else -1, *split.vocab)
    if not split.trunk:
        return None
    if "moe" in path:
        if "shared" in path:
            if key in ("w_gate", "w_up", "w_in"):
                return (-1, *split.fe)
            return (-2, *split.fe)                 # w_out
        if key in ("w_gate", "w_up", "w_out"):     # (L, E, ...) stacks
            return (1, *split.experts)
        return None                                # the router
    if "rec" in path:
        if key in _REC_CHAN:
            return (-1, *split.chan)
        if key in ("w_a", "w_i"):                  # (..., nb, bw, bw)
            return (-3, *split.q)
        if key == "w_out":
            return (-2, *split.chan)
        return None                                # the block's norm
    if key in _RWKV_CHAN:
        return (-1, *split.chan)
    if key == "w_o":
        return (-2, *split.chan)
    if key == "w_k_cm":
        return (-1, *split.ff)
    if key == "w_v_cm":
        return (-2, *split.ff)
    if key == "wq":
        return (-1, split.q[0] * hd, split.q[1] * hd)
    if key in ("wk", "wv"):
        return (-1, split.kv[0] * hd, split.kv[1] * hd)
    if key == "wo":
        return (-2, split.q[0] * hd, split.q[1] * hd)
    if key in ("w_gate", "w_up", "w_in"):
        return (-1, *split.ff)
    if key == "w_out":
        return (-2, *split.ff)
    return None           # norms, rwkv6's mu_* and wA: replicated


def _cuts(path: tuple, shape, cfg: ModelConfig, split: Optional[Split],
          dcut: Optional["DataCut"]) -> list:
    """The (axis, lo, hi) cuts of the leaf at ``path`` of whole shape
    ``shape`` in the order a rank takes them: its model cut
    (``leaf_cut``), then its data cut of that (``data_cut``)."""
    out = []
    shape = list(shape)
    if split is not None:
        cut = leaf_cut(path, cfg, split)
        if cut is not None:
            out.append(cut)
            shape[cut[0]] = cut[2] - cut[1]
    cut = data_cut(path, shape, cfg, split, dcut)
    if cut is not None:
        out.append(cut)
    return out


def rank_shape(path: tuple, shape, cfg: ModelConfig,
               split: Optional[Split],
               dcut: Optional["DataCut"] = None) -> tuple:
    """The shape of a rank's cut of the leaf at ``path`` whose whole
    shape is ``shape`` (``shard_leaf``'s result's)."""
    shape = list(shape)
    for ax, lo, hi in _cuts(path, shape, cfg, split, dcut):
        shape[ax] = hi - lo
    return tuple(shape)


def shard_leaf(path: tuple, x, cfg: ModelConfig, split: Optional[Split],
               dcut: Optional["DataCut"] = None):
    """Rank ``split.rank``'s slice of the leaf at ``path`` (a numpy array
    or a torch tensor; a view), as ``leaf_cut`` says, then under
    ``dcut`` its data index's 1/D of that (``data_cut``)."""
    for ax, lo, hi in _cuts(path, x.shape, cfg, split, dcut):
        idx = [slice(None)] * x.ndim
        idx[ax] = slice(lo, hi)
        x = x[tuple(idx)]
    return x


def vocab_cut(cfg: ModelConfig) -> bool:
    """Whether the rank's view ``cfg`` (``local_config``) holds a slice of
    the vocabulary: a split over more than one rank whose range is not
    the whole V.  False for an unsplit config and for a training split
    that keeps V whole (``plan(whole_vocab=True)``): its embedding
    lookup, head and loss are then the plain, whole ones on every
    rank."""
    sh = cfg.shard
    return sh is not None and sh.world > 1 \
        and sh.vocab != (0, cfg.vocab_size)


# -- training on a (data, model) mesh ----------------------------------------
# replicated leaves whose gradient is a part on each model rank: each
# rank's qk-norm scales meet only its own heads (a copied kv head's
# k_norm too: each copy meets only its rank's q heads); the router's
# combine weights reach only the rank's experts (its router loss, whole
# on every rank, carries 1 / M of its gradient, ``parallel.moe_ep``)
PARTIAL_GRAD = ("q_norm", "k_norm", "router")
# the leaves of a kv head copied to several ranks of the model group
KV_COPY = ("wk", "wv")
# the attentions whose kv heads those are: self-attention (an encoder's
# too) and an ``xattn`` layer's cross-attention
_KV_ATTN = ("attn", "xattn")


# -- the data cut (FSDP) ------------------------------------------------------
# the reference's data position in each leaf's trailing base axes, key ->
# (base rank, the index of "data" among them): ``_PARAM_RULES`` /
# ``_MOE_RULES`` (``repro/parallel/sharding.py:26-54``) with their model
# entries left out; the leaves they do not cut over data (the norms,
# conv_w / conv_b, b_a, b_i, lam, w_a, w_i, rwkv6's mu_*, w0, u, ln_x)
# are absent
_DATA_RULES = {
    "embed": (2, 1), "lm_head": (2, 0),
    "wq": (2, 0), "wk": (2, 0), "wv": (2, 0), "wo": (2, 1),
    "w_gate": (2, 0), "w_up": (2, 0), "w_in": (2, 0), "w_out": (2, 1),
    "w_r": (2, 0), "w_k": (2, 0), "w_v": (2, 0), "w_g": (2, 0),
    "w_o": (2, 1), "wA": (2, 0), "wB": (2, 1),
    "w_k_cm": (2, 0), "w_v_cm": (2, 1), "w_r_cm": (2, 0),
    "w_x": (2, 0), "w_gate_in": (2, 0),
    "router": (2, 0),
}
# a ``moe`` layer's expert stacks (not its shared expert's): (E, D, Fe)
# and (E, Fe, D), the D axis over data
_MOE_DATA_RULES = {"w_gate": (3, 1), "w_up": (3, 1), "w_out": (3, 2)}


@dataclasses.dataclass(frozen=True)
class DataCut:
    """A training rank's place on a data axis of ``world`` > 1 ranks:
    its data index ``d``; ``group``, the data group its cut leaves are
    gathered and their gradients reduce-scattered over; ``full``, the
    whole config, whose leaves' shapes ``data_axis`` reads."""

    d: int
    world: int
    group: Any = dataclasses.field(default=None, compare=False, repr=False)
    full: Any = dataclasses.field(default=None, compare=False, repr=False)

    def axis(self, path: tuple) -> Optional[int]:
        """``data_axis`` of the leaf at ``path``."""
        return data_axis(path, self.full, self.world)


@functools.lru_cache(maxsize=32)
def _whole_shapes(cfg: ModelConfig) -> dict:
    from repro_torch import weights

    return weights.param_shapes(cfg)


def _param_path(path: tuple):
    """(the param path, ``"vr"`` / ``"vc"`` for a factored second
    moment's part or None) of a leaf's path in a param or gradient tree
    or a train state; (None, None) for AdamW's step."""
    path = tuple(path)
    if path[:1] == ("params",):
        return path[1:], None
    if path[:1] == ("opt",):
        if path[1:2] not in (("m",), ("v",)):
            return None, None
        path = path[2:]
        if path and path[-1] in ("vr", "vc"):
            return path[:-1], path[-1]
    return path, None


def data_axis(path: tuple, cfg: ModelConfig, data: int) -> Optional[int]:
    """The axis the reference's ``param_specs`` cuts over ``"data"`` in the
    leaf at ``path`` (of a param or gradient tree or a train state) of
    the WHOLE config ``cfg`` on a data axis of ``data``, or None: its
    rule's data position after the leading stack axes, dropped where the
    whole dimension does not divide by ``data``
    (``repro/parallel/sharding.py:95-110``), none at ``data`` 1.  A
    factored second moment's ``vr`` / ``vc`` keep the cut of the axis
    they do not reduce (``opt_state_specs`` :231-255)."""
    if data < 2:
        return None
    ppath, part = _param_path(path)
    if not ppath:
        return None
    key = ppath[-1]
    in_moe = "moe" in ppath and "shared" not in ppath
    table = _MOE_DATA_RULES if in_moe and key in _MOE_DATA_RULES \
        else _DATA_RULES
    if key not in table:
        return None
    shape = tree_mod.get(_whole_shapes(cfg), ppath)[0]
    base, pos = table[key]
    ax = len(shape) - base + pos
    if shape[ax] % data:
        return None
    n = len(shape)
    if part == "vr":                       # the last axis reduced
        return None if ax == n - 1 else ax
    if part == "vc":                       # the second-to-last reduced
        return None if ax == n - 2 else (ax if ax < n - 2 else ax - 1)
    return ax


def data_cut(path: tuple, shape, cfg: ModelConfig, split: Optional[Split],
             dcut: Optional[DataCut]) -> Optional[Tuple[int, int, int]]:
    """(axis, lo, hi): where data index ``dcut.d`` cuts the leaf at
    ``path`` whose model cut (``split``'s; the whole leaf where it is
    None) has ``shape``, or None for a leaf the data axis holds whole
    (``data_axis``).  Raises where the rank's extent there does not
    divide by D (only RWKV6's ``wB`` can: its data axis is the one the
    port's own channel cut takes too)."""
    ax = None if dcut is None else dcut.axis(path)
    if ax is None:
        return None
    if split is not None:
        cut = leaf_cut(path, cfg, split)
        assert cut is None or cut[0] % len(shape) != ax \
            or path[-1] == "wB", (path, cut, ax)
    n = shape[ax]
    if n % dcut.world:
        raise ValueError(f"{tree_mod.key(path)}: a rank's {n} along axis "
                         f"{ax} do not divide by the data axis of "
                         f"{dcut.world}")
    per = n // dcut.world
    return ax, dcut.d * per, (dcut.d + 1) * per


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """One rank's place in a (data, model) mesh of ``data x model`` ranks:
    ``d`` its data index (its block of the global batch's rows), ``m``
    its model index, ``split`` its cut of the model (None at model 1),
    ``dcut`` its cut of the data-cut leaves (None at data 1)."""

    data: int
    model: int
    d: int
    m: int
    split: Optional[Split]
    dcut: Optional[DataCut] = None


def train_plan(cfg: ModelConfig, rank: int, data: int, model: int, *,
               group=None, data_group=None) -> TrainPlan:
    """Rank ``rank``'s plan in a mesh of ``data x model`` ranks; ``group``
    (the rank's model group) rides on the split, ``data_group`` on the
    data cut.  Rank ``r`` is at data index ``r // model`` and model
    index ``r % model``.  Raises ``ValueError`` where the mesh does not
    hold the rank, where ``plan`` refuses the split (heads, widths or
    experts that do not divide by ``model``, q heads that would read
    part of a kv group), where a data-cut leaf's model cut does not
    divide by ``data``, and where a ``moe`` config cut over ``data``
    routes with another executor than gshard (``layers.moe_layer``).
    Every family splits; a vocabulary that does not divide by ``model``
    is held whole on every rank (``plan(whole_vocab=True)``, the
    reference's ``param_specs``).  A kv head that does not divide by
    ``model`` is copied to the ranks whose q heads read it
    (``kv_copies``)."""
    if data < 1 or model < 1 or not 0 <= rank < data * model:
        raise ValueError(f"rank {rank} outside a mesh of {data}x{model}")
    if data > 1 and cfg.moe is not None and cfg.moe_impl not in (
            "auto", "gshard"):
        raise ValueError(f"{cfg.name}: moe_impl {cfg.moe_impl!r} under a "
                         f"data axis of {data}: only gshard's groups lie "
                         "within a row, so that cutting rows over data "
                         "leaves routing and drops unchanged")
    split = dcut = None
    if model > 1:
        split = plan(cfg, rank % model, model, group=group,
                     whole_vocab=True)
    if data > 1:
        dcut = DataCut(rank // model, data, data_group, cfg)
        rank_param_count(cfg, split, dcut)       # raises where it must
    return TrainPlan(data, model, rank // model, rank % model, split, dcut)


def kv_copies(cfg: ModelConfig, model: int) -> Optional[list]:
    """The model indices of a model axis of ``model`` grouped by the kv
    heads they hold, where those are copies (the kv heads do not divide by
    ``model``: ``_kv_range``), in order; None where every rank holds kv
    heads of its own (or the family has no attention to split)."""
    if model < 2 or cfg.family == "ssm" or cfg.n_kv_heads % model == 0:
        return None
    sets = {}
    for m in range(model):
        sets.setdefault(plan(cfg, m, model, whole_vocab=True).kv,
                        []).append(m)
    return list(sets.values())


def kv_copy_leaf(path: tuple) -> bool:
    """Whether the leaf at ``path`` is an attention's wk / wv (a
    self-attention's or an ``xattn`` layer's cross-attention's), which a
    copied kv head holds on several ranks."""
    return bool(path) and path[-1] in KV_COPY \
        and any(a in path for a in _KV_ATTN)


def split_axis(path: tuple, cfg: ModelConfig,
               split: Optional[Split]) -> Optional[int]:
    """The axis ``shard_leaf`` cuts the leaf at ``path`` along under
    ``split`` (``leaf_cut``, the same path rule), or None for a leaf the
    rank holds whole."""
    if split is None:
        return None
    cut = leaf_cut(path, cfg, split)
    return None if cut is None else cut[0]


def partial_grad(path: tuple) -> bool:
    """Whether the gradient of the replicated leaf at ``path`` is a part
    on each model rank (the qk-norm scales, the router), to be summed
    over the model group."""
    return bool(path) and path[-1] in PARTIAL_GRAD


def gather_tree(tree, cfg: ModelConfig, split: Optional[Split],
                kind: str = "gather", dcut: Optional[DataCut] = None):
    """A rank's cut of a tree (params, gradients or a train state) put
    back into the whole layout: under ``dcut`` every data-cut leaf
    all-gathered over the data group and joined along its data axis in
    rank order, then every split leaf all-gathered over the split's
    group and its slices joined along its axis in rank order (a copied
    kv head's from the first rank that holds it); a replicated leaf as
    it is.  Collective over the data group, then the model group: every
    member calls it.  ``split`` and ``dcut`` None: the tree as it is."""
    import torch

    if split is None and dcut is None:
        return tree
    copies = kv_copies(cfg, split.world) \
        if split is not None and split.trunk else None
    firsts = None if copies is None else [ms[0] for ms in copies]

    def leaf(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        if dcut is not None:
            ax = dcut.axis(path)
            if ax is not None:
                x = torch.cat(list(dcut.group.all_gather(x.contiguous(),
                                                         kind)), dim=ax)
        ax = split_axis(path, cfg, split)
        if ax is None:
            return x
        parts = list(split.group.all_gather(x.contiguous(), kind))
        if firsts is not None and kv_copy_leaf(path):
            parts = [parts[m] for m in firsts]
        return torch.cat(parts, dim=ax)

    return tree_mod.map_tree(leaf, tree)


def gather_to_host(tree, cfg: ModelConfig, split: Optional[Split],
                   dcut: Optional[DataCut], kind: str = "ckpt"):
    """``gather_tree``'s whole layout on rank 0's host alone, leaf by
    leaf: every other data index sends its cut of a data-cut leaf to data
    index 0, which joins the cuts along the data axis; every other model
    index of the first data group sends its slice of a split leaf to
    model index 0 (of a copied kv head, the first rank that holds it
    alone), which joins the slices; rank 0 moves the leaf to the host
    before the next is gathered.  So no rank holds more than one whole
    leaf on the device, and a sending rank's memory stays as it was.
    The sends count their bytes under ``kind``.  Every rank calls it;
    it returns None on every rank but rank 0."""
    import torch

    copies = kv_copies(cfg, split.world) \
        if split is not None and split.trunk else None
    firsts = None if copies is None else [ms[0] for ms in copies]
    first = (dcut is None or dcut.d == 0) and (split is None
                                               or split.rank == 0)

    def to_first(x, group, me: int, ax: int, members):
        """``members``' parts of ``x`` joined along ``ax`` on member 0
        (which is always one of them), None elsewhere."""
        if me != 0:
            if me in members:
                group.send(x, 0, kind)
            return None
        return torch.cat([x if m == 0 else group.recv(
            torch.empty(x.shape, dtype=x.dtype, device=x.device), m)
            for m in members], dim=ax)

    def leaf(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        ax = None if dcut is None else dcut.axis(path)
        if ax is not None:
            x = to_first(x, dcut.group, dcut.d, ax, range(dcut.world))
        elif dcut is not None and dcut.d != 0:
            return None
        ax = split_axis(path, cfg, split)
        if x is not None and ax is not None:
            members = firsts if firsts is not None and kv_copy_leaf(path) \
                else range(split.world)
            x = to_first(x, split.group, split.rank, ax, members)
        return None if x is None or not first else x.cpu()

    whole = tree_mod.map_tree(leaf, tree)
    return whole if first else None
