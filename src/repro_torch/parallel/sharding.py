"""The tensor-parallel serve split of the dense and moe families' param
trees.

Counterpart of ``repro.parallel.sharding`` (``_PARAM_RULES`` :26-44,
``_MOE_RULES`` :49-54, ``param_specs`` :75-113, ``paged_pool_specs``
:142-163) for serving:

  column-parallel   wq, wk, wv, w_gate, w_up, w_in (their output columns)
  row-parallel      wo, w_out (their input rows; an all-reduce follows)
  experts           a ``moe`` layer's expert stacks w_gate / w_up / w_out
                    (E, ...), split along E into contiguous rank-ordered
                    ranges (expert parallelism, ``repro.parallel.moe_ep``)
  vocabulary        the embedding (V, D) and an untied lm_head (D, V),
                    split along V into contiguous rank-ordered ranges
  replicated        the norms (ln1, ln2, final_norm, q_norm, k_norm) and
                    the router

A leaf's rule follows its path, not its name alone: under ``moe`` (and
not under ``shared``) the expert stacks, whose names are the dense MLP's,
split along E; ``moe/shared/*`` splits like ``mlp/*``, at the shared
expert's width.  Every rank routes every token over all E experts with
the global capacity (``local_config`` keeps ``cfg.moe`` whole), computes
its own experts' kept slots and its part of the shared expert, and one
all-reduce sums the ranks' shares -- the dense MLP's bytes.

Heads are split WHOLE.  The q heads must divide by the world size.  The
kv heads are split when they divide too; otherwise every rank keeps a
copy of the kv heads its q heads read (each rank's q heads must then
read one kv head, or whole kv groups), and its paged pool holds those.
The reference's GSPMD rule divides columns instead, which at smoke size
and tp 4 cuts ``wk`` (64, 32) into half heads; the whole-head rule gives
the same tokens (``tests/test_torch_tp.py``).

The reference's fallback to the training layout for a model that does
not fit once sharded (``serve_param_specs`` :116-139) is not ported:
``plan`` raises with the per-rank bytes instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.configs.base import ModelConfig

_COL = ("wq", "wk", "wv", "w_gate", "w_up", "w_in")
_ROW = ("wo", "w_out")


@dataclasses.dataclass(frozen=True)
class Split:
    """One rank's cut of a model: half-open ranges of q heads, kv heads,
    MLP columns and vocabulary ids, and, for the moe family, of experts
    and of the shared expert's columns; ``trunk`` False keeps the trunk
    whole (only the head's vocabulary is split).  ``group``, the
    ranks the cut is shared over, rides along once the split is the
    rank's (``local_config`` puts it on the rank's cfg as ``cfg.shard``,
    where ``lm`` and the samplers read it)."""

    rank: int
    world: int
    trunk: bool
    q: Tuple[int, int]
    kv: Tuple[int, int]
    ff: Tuple[int, int]
    vocab: Tuple[int, int]
    experts: Tuple[int, int] = (0, 0)
    fe: Tuple[int, int] = (0, 0)
    group: Any = dataclasses.field(default=None, compare=False, repr=False)


def _even(n: int, world: int, rank: int, what: str) -> Tuple[int, int]:
    if n % world:
        raise ValueError(f"{what}={n} does not divide by the world size "
                         f"{world}")
    per = n // world
    return rank * per, (rank + 1) * per


def plan(cfg: ModelConfig, rank: int, world: int, *, trunk: bool = True,
         max_bytes_per_rank: Optional[float] = None, group=None) -> Split:
    """Rank ``rank``'s share of ``cfg`` among ``world`` ranks (of
    ``group``, where there is one).  Raises
    ``ValueError`` where the q heads, the MLP width, the experts, the
    shared expert's width or the vocabulary do not divide by ``world``,
    where a rank's q heads would read part of a kv group, or where a
    rank's compute-dtype weights exceed ``max_bytes_per_rank``."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r}: tensor parallelism covers the dense "
            "and moe families")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    vocab = _even(cfg.vocab_size, world, rank, "vocab_size")
    m = cfg.moe
    if not trunk:
        return Split(rank, world, False, (0, cfg.n_heads),
                     (0, cfg.n_kv_heads), (0, cfg.d_ff), vocab,
                     (0, m.num_experts) if m else (0, 0),
                     (0, m.d_ff_expert) if m else (0, 0), group)
    q = _even(cfg.n_heads, world, rank, "n_heads")
    per_kv = cfg.n_heads // cfg.n_kv_heads        # q heads per kv head
    if cfg.n_kv_heads % world == 0:
        kv = _even(cfg.n_kv_heads, world, rank, "n_kv_heads")
    else:
        # a copy of the kv heads this rank's q heads read: valid when
        # they read one kv head, or whole kv groups
        kv = (q[0] // per_kv, (q[1] - 1) // per_kv + 1)
        whole = q[0] % per_kv == 0 and (q[1] - q[0]) % per_kv == 0
        if not (whole or kv[1] - kv[0] == 1):
            raise ValueError(
                f"n_heads={cfg.n_heads}, n_kv_heads={cfg.n_kv_heads} at "
                f"world {world}: rank {rank}'s q heads {q} read part of a "
                "kv group; whole heads cannot be split so")
    ff = _even(cfg.d_ff, world, rank, "d_ff")
    experts = fe = (0, 0)
    if m is not None:
        experts = _even(m.num_experts, world, rank, "num_experts")
        fe = _even(m.d_ff_expert, world, rank, "d_ff_expert")
    split = Split(rank, world, True, q, kv, ff, vocab, experts, fe, group)
    if max_bytes_per_rank is not None:
        need = rank_param_count(cfg, split) * (
            2 if cfg.dtype == "bfloat16" else 4)
        if need > max_bytes_per_rank:
            raise ValueError(
                f"{cfg.name} at world {world}: {need / 1e9:.2f} GB of "
                f"weights a rank, more than {max_bytes_per_rank / 1e9:.2f}; "
                "the training layout's fallback is not ported")
    return split


def local_config(cfg: ModelConfig, split: Split) -> ModelConfig:
    """The rank's view of ``cfg``: its q heads, kv heads and MLP width
    (what the layers, the caches and the pools are built at), and
    ``shard`` the split itself; ``vocab_size`` stays whole, the rank's
    ids are ``split.vocab``, and ``moe`` stays whole too: the router's E
    columns and the capacity ``ceil(cf * N * k / E)`` are over all the
    experts (a rank that shrank E would drop other tokens), the rank's
    experts are ``split.experts``."""
    if not split.trunk:
        return dataclasses.replace(cfg, shard=split)
    return dataclasses.replace(cfg, n_heads=split.q[1] - split.q[0],
                               n_kv_heads=split.kv[1] - split.kv[0],
                               d_ff=split.ff[1] - split.ff[0], shard=split)


def rank_param_count(cfg: ModelConfig, split: Split) -> int:
    """Parameters a rank holds under ``split``: per layer its attention
    heads and norms, then a dense layer's MLP columns, or a ``moe``
    layer's router, its experts (always three (d, Fe) matrices, as the
    reference's ``init_moe``) and its shared-expert columns."""
    hd, d = cfg.head_dim, cfg.d_model
    nq, nkv = split.q[1] - split.q[0], split.kv[1] - split.kv[0]
    nf, nv = split.ff[1] - split.ff[0], split.vocab[1] - split.vocab[0]
    mats = 3 if cfg.activation.endswith("_glu") else 2
    attn = 2 * d * nq * hd + 2 * d * nkv * hd + 2 * d \
        + (2 * hd if cfg.qk_norm else 0)
    n_moe = 0
    per_moe = 0
    m = cfg.moe
    if m is not None:
        n_moe = cfg.n_layers // m.interleave_step
        ne = split.experts[1] - split.experts[0]
        nfe = split.fe[1] - split.fe[0]
        per_moe = d * m.num_experts + ne * 3 * d * m.d_ff_expert \
            + (mats * d * nfe if m.shared_expert else 0)
    heads = (1 if cfg.tie_embeddings else 2) * nv * d
    if not split.trunk:
        heads = (1 if cfg.tie_embeddings else 2) * cfg.vocab_size * d
    return cfg.n_layers * attn + (cfg.n_layers - n_moe) * mats * d * nf \
        + n_moe * per_moe + heads + d


def _cols(x, lo: int, hi: int):
    return x[..., lo:hi]


def _rows(x, lo: int, hi: int):
    return x[..., lo:hi, :]


def shard_leaf(path: tuple, x, cfg: ModelConfig, split: Split):
    """Rank ``split.rank``'s slice of the leaf at ``path`` (a numpy array or
    a torch tensor; a view).  The rule follows the path: a ``moe`` layer's
    expert stacks split along their expert axis, its shared expert like a
    dense MLP at its own width, its router not at all."""
    key = path[-1]
    hd = cfg.head_dim
    if split.trunk and "moe" in path:
        if "shared" in path:
            if key in ("w_gate", "w_up", "w_in"):
                return _cols(x, *split.fe)
            return _rows(x, *split.fe)             # w_out
        if key in ("w_gate", "w_up", "w_out"):     # (L, E, ...) stacks
            return x[:, split.experts[0]:split.experts[1]]
        return x                                   # the router
    if key == "embed":
        return x[split.vocab[0]:split.vocab[1]] if split.trunk else x
    if key == "lm_head":
        return _cols(x, *split.vocab) if split.trunk else x
    if not split.trunk or key not in _COL + _ROW:
        return x                                   # norms: replicated
    if key == "wq":
        return _cols(x, split.q[0] * hd, split.q[1] * hd)
    if key in ("wk", "wv"):
        return _cols(x, split.kv[0] * hd, split.kv[1] * hd)
    if key == "wo":
        return _rows(x, split.q[0] * hd, split.q[1] * hd)
    if key in ("w_gate", "w_up", "w_in"):
        return _cols(x, *split.ff)
    return _rows(x, *split.ff)                     # w_out
