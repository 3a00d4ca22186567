"""Compositional roofline costing of one rank's step, walked on ``meta``.

Counterpart of ``repro.launch.segment_cost``.  The reference lowers
each SEGMENT of the program, because XLA counts a scanned layer stack's
body once; eager PyTorch has no scan -- a whole-step walk counts every
layer -- but a walk dispatches every op in Python, so the cell walks
each segment once and scales it by its repeat count:

  train:   cast -> embed -> [layer kind x count ...] -> head+loss
           -> optimizer
  prefill: embed -> [layer kind x count ...] -> head(mode)
  decode:  embed -> [layer kind x count ...] -> head(mode)

Each segment runs the rank's real step code (``models.lm``'s
``embed_step``, ``encoder_input`` / ``encoder_output``, ``run_units``,
``prefill_layer`` / ``decode_layer``, ``models.api.head_loss``,
``launch.steps.complete_grads``, ``optim.optimizer.update``) on ``meta``
tensors under its mesh's ``comm.CountingGroup``s, inside a
``hlo_stats.Counter``:

  cast       (train) ``weights.cast_params`` of the rank's f32 masters,
             every layer's views of the stacked leaves
             (``lm.layer_params``; a data-cut leaf's f32 cut, FSDP), and
             the backward of it all: each layer's gradient accumulated
             into its stacked leaf, a tied embedding's two gradients
             summed, the casts back to f32
  embed      the embedding and the step constants (``lm.embed_step``,
             in training forward and backward; a data-cut embedding's
             gather and its gradient's reduce-scatter, a tied one's
             two gradients summed first), a vlm config's image
             prefix; an encdec config's ``encoder_input`` and
             ``encoder_output`` (in training its gradient summed over
             the ``xattn`` layers); a prefill's fresh cache; a decode
             step's ``decode_constants`` and token embeddings
  layer_<k>  one layer of kind k from the compute-dtype leaves: in
             training ``lm.run_units`` over it as a unit of its own
             (under the config's remat: a data-cut leaf's gathers and
             its gradient's reduce-scatter inside), forward and backward
             to the leaves and the input; in serving ``lm.prefill_layer`` /
             ``lm.decode_layer`` over a cache of one layer (an ``enc``
             layer: ``lm.run_units``); scaled by the count of its kind
             (the encoder's ``enc`` layers too; in training the
             encoder's first, whose input takes no gradient, apart)
  head_loss  the final norm and ``api.head_loss``, forward and backward
             (train)
  optimizer  ``complete_grads`` and AdamW over the rank's slice (train)
  head_<m>   the final norm and the sampler head, under BOTH units --
             ``softmax`` (the baseline) and ``reduced`` (the paper) --
             with ``reduced`` in the total (serve)

The segments' FLOPs and collective bytes times their counts add up to a
whole-step walk of the same rank exactly, their HBM bytes to within a
few bytes a unit (the scalar router-loss sums; ``tests/
test_torch_dryrun.py``).

Memory (per rank, bytes): ``params``, ``optimizer``, ``gradients`` and
``cache`` from the trees' shapes; ``activations`` from the walks.  In
training: what the cast and each layer keep (``kept``: what a forward
leaves alive for the backward) times its count, plus the largest peak
of the embed or the head segment or of the cast's or a layer's above
its own kept bytes (the optimizer's peak alone, if larger: it runs once
the activations are freed).  In serving: the largest working set of any
segment above what it leaves behind.  Every gradient is counted live
beside the activations, so the training total is an upper estimate.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch import weights
from repro_torch.configs.base import ModelConfig, ShapeSpec, \
    per_layer_attn_count
from repro_torch.launch import hlo_stats, steps
from repro_torch.models import api, lm
from repro_torch.optim import optimizer as opt_mod
from repro_torch.parallel import comm
from repro_torch.serve.sampler import resolve

HEAD_MODES = ("softmax", "reduced")


def _empty(shape, dtype, grad: bool = False) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def _like(a: torch.Tensor, grad: bool = False) -> torch.Tensor:
    """A fresh ``meta`` tensor of ``a``'s shape, strides and dtype."""
    return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                               device="meta", requires_grad=grad)


def _fresh(tree, grad: bool = False, layer: bool = False):
    """A tree of fresh ``meta`` tensors like ``tree``'s (with ``layer``,
    one layer of a stacked tree: the leading axis taken off); a
    ``comm.Shard``'s cut made fresh in the same way."""
    def fresh(_, a):
        if isinstance(a, comm.Shard):
            return comm.Shard(fresh(_, a.x), a.axis - layer, a.group,
                              a.dtype)
        if layer:
            return _empty(tuple(a.shape[1:]), a.dtype, grad)
        return _like(a, grad)

    return tree_mod.map_tree(fresh, tree)


def _tensor(a) -> torch.Tensor:
    """A leaf's tensor: a ``comm.Shard``'s f32 cut."""
    return a.x if isinstance(a, comm.Shard) else a


def _gathered(a: comm.Shard, grad: bool = False) -> torch.Tensor:
    """A fresh ``meta`` tensor of ``a`` gathered whole."""
    shape = list(a.x.shape)
    shape[a.axis] *= a.group.world
    return _empty(tuple(shape), a.dtype, grad)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_mod.leaves(tree)
               if isinstance(t, torch.Tensor))


def layer_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Each layer kind's count in the decoder's block program."""
    counts: Dict[str, int] = {}
    for unit, count in lm.segments(cfg):
        for kind in unit:
            counts[kind] = counts.get(kind, 0) + count
    return counts


def _first_slot(tree: dict, cfg: ModelConfig, kind: str):
    """The first slot of layer kind ``kind`` in a stacked tree (params
    or a cache): the decoder's, or the encoder's for ``enc``."""
    if kind == "enc":
        return tree["encoder"][0]["slot0"]
    segs = tree["decoder"] if isinstance(tree, dict) else tree
    for seg, (unit, _) in zip(segs, lm.segments(cfg)):
        for j, k in enumerate(unit):
            if k == kind:
                return seg[f"slot{j}"]
    raise KeyError(kind)


def _stacks(cfg: ModelConfig):
    return ("decoder", "encoder") if cfg.n_encoder_layers else ("decoder",)


def _cast_uses(cast: dict, cfg: ModelConfig) -> list:
    """What the step reads of the cast tree ``cast``: every leaf outside
    the stacks (a tied embedding twice: the lookup and the head), and
    every layer's views of the stacked leaves (``lm.layer_params``; a
    data-cut leaf's layer views of its f32 cut).  A data-cut leaf outside
    the stacks is read by its gather alone (the embed and head
    segments)."""
    outs = [t for k, v in cast.items() if k not in _stacks(cfg)
            for t in tree_mod.leaves(v) if not isinstance(t, comm.Shard)]
    if cfg.tie_embeddings and not isinstance(cast["embed"], comm.Shard):
        outs.append(cast["embed"])
    for stack in _stacks(cfg):
        outs += [_tensor(t) for t in
                 tree_mod.leaves(lm.layer_params(cast, cfg, stack))]
    return outs


class _Walks:
    """The segments of one cell: each walk's ``RooflineTerms`` under its
    count, and its memory (``peak``, ``kept``, ``end``)."""

    def __init__(self, groups):
        self.groups = groups
        self.segments: Dict[str, dict] = {}
        self.memory: Dict[str, dict] = {}
        self.total = hlo_stats.ZERO

    def walk(self, name: str, count: int, fn, accumulate: bool = True):
        """Run ``fn(mark)`` inside a ``Counter``; ``mark()`` records the
        live bytes at the end of a training segment's forward, and what
        ``fn`` returns is held while the live bytes at its end are
        read."""
        before = _sum_bytes(self.groups)
        kept = [0]
        with hlo_stats.Counter() as c:
            out = fn(lambda: kept.__setitem__(0, c.live))
            end = c.live
            del out
        after = _sum_bytes(self.groups)
        coll = {k: n - before.get(k, 0) for k, n in after.items()}
        terms = hlo_stats.terms(c, coll)
        self.segments[name] = dict(count=count, **terms.as_dict())
        self.memory[name] = dict(peak=c.peak, kept=kept[0], end=end)
        if accumulate:
            self.total = self.total + terms.scaled(count)
        return terms


def _grad(outs, ins, cts):
    """The backward of ``outs`` (those that require grad) to ``ins``."""
    pairs = [(o, g) for o, g in zip(outs, cts) if o.requires_grad]
    torch.autograd.grad([o for o, _ in pairs], ins, [g for _, g in pairs],
                        allow_unused=True)


# ---------------------------------------------------------------------------
# Cell costing
# ---------------------------------------------------------------------------
def train_cell(cfg: ModelConfig, opt_cfg, shape: ShapeSpec, data: int = 1,
               model: int = 1, rank: int = 0, walk: bool = True) -> dict:
    """Rank ``rank``'s training step of ``shape`` on a ``data x model``
    mesh: segments, totals, memory (``walk`` False: the trees' bytes
    alone)."""
    state, batch, mesh = steps.train_specs(cfg, opt_cfg, shape, data, model,
                                           rank)
    local, params = mesh.cfg, state["params"]
    p_bytes = tree_bytes(params)
    memory = dict(params=p_bytes, optimizer=tree_bytes(state["opt"]),
                  gradients=p_bytes, cache=0)
    if not walk:
        return _cell(None, memory, batch["tokens"].shape[0])
    group, dgroup = lm.trunk_group(local), mesh.data
    rows, S = batch["tokens"].shape
    dt = weights.dtype_of(cfg)
    x_shape = (rows, S, cfg.d_model)
    w = _Walks([mesh.data, mesh.model, mesh.kv])
    # each segment's inputs, made outside its walk: the cast tree's
    # leaves (their gradients arriving at the cast), the step constants,
    # the layers' input and output gradient
    cast = _fresh(weights.cast_params(params, local, mesh.dcut), grad=True)
    cast_cts = [_like(t) for t in _cast_uses(cast, local)]
    # a data-cut tied embedding: the head reads its gather, whose
    # gradient the embed segment sums into the lookup's
    tied_cut = cfg.tie_embeddings and isinstance(cast["embed"], comm.Shard)
    head_cast = dict(cast, embed=_gathered(cast["embed"], grad=True)) \
        if tied_cut else cast
    consts = lm.step_constants(local, torch.arange(S, device="meta"))
    x_in, ct, one = (_empty(x_shape, dt, grad=True), _empty(x_shape, dt),
                     _empty((), torch.float32))
    enc_out = enc_consts = None
    if cfg.n_encoder_layers:
        src = batch["src_embeds"]
        enc_out = _empty(src.shape, dt, grad=True)
        enc_in = _empty(src.shape, dt, grad=True)
        enc_ct = _empty(src.shape, dt)
        enc_consts = lm.encoder_input(local, src)[1]

    def cast_walk(mark):
        live = tree_mod.map_tree(
            lambda _, a: a.detach().requires_grad_(True), params)
        outs = _cast_uses(weights.cast_params(live, local, mesh.dcut),
                          local)
        mark()
        _grad(outs, tree_mod.leaves(live), cast_cts)

    w.walk("cast", 1, cast_walk)

    def embed(mark):
        emb = comm.whole(cast["embed"])
        x = lm.embed_step(dict(cast, embed=emb), local, batch["tokens"],
                          batch.get("image_embeds"))[0]
        outs, ins, cts = [x], [_tensor(cast["embed"])], [ct]
        if tied_cut:
            outs.append(emb)
            cts.append(_like(emb))
        if cfg.n_encoder_layers:
            lm.encoder_input(local, src)
            # each xattn layer's gradient of the encoder's output
            n = layer_counts(cfg)["xattn"]
            outs += [lm.encoder_output(cast, local, enc_in)] * n
            ins += [cast["encoder_norm"], enc_in]
            cts += [_like(enc_out) for _ in range(n)]
        mark()
        _grad(outs, ins, cts)

    w.walk("embed", 1, embed)

    def layer(kind: str, count: int, name: str = "", x_grad: bool = True):
        p = _fresh(_first_slot(cast, cfg, kind), grad=True, layer=True)
        enc = kind == "enc"
        xin, xct = (enc_in, enc_ct) if enc else (x_in, ct)
        xin = xin if x_grad else xin.detach()
        cross = enc_out if kind == "xattn" else None

        def fn(mark):
            y, aux = lm.run_units(
                [[[p]]], [((kind,), 1)], xin, local,
                enc_consts if enc else consts, group, cross,
                None if enc else dgroup)
            mark()
            ins = [_tensor(t) for t in tree_mod.leaves(p)] \
                + [xin] * x_grad + (
                [cross] if cross is not None else [])
            _grad([y, aux], ins, [xct, one])

        w.walk(name or f"layer_{kind}", count, fn)

    for kind, count in layer_counts(cfg).items():
        layer(kind, count)
    if cfg.n_encoder_layers:
        # the encoder's first layer reads the cast source embeddings,
        # which take no gradient
        if cfg.n_encoder_layers > 1:
            layer("enc", cfg.n_encoder_layers - 1)
        layer("enc", 1, "layer_enc_first", x_grad=False)

    head = [_tensor(head_cast["embed" if cfg.tie_embeddings
                              else "lm_head"]), cast["final_norm"]]

    def head_loss(mark):
        loss = api.head_loss(head_cast, local,
                             lm.final_hidden(cast, local, x_in), batch,
                             data=dgroup)
        mark()
        _grad([loss], head + [x_in], [one])

    w.walk("head_loss", 1, head_loss)

    grads = _fresh(params)
    loss = _empty((), torch.float32)

    def optimizer(mark):
        steps.complete_grads(loss, grads, mesh)
        opt_mod.update(opt_cfg, grads, state["opt"], params,
                       **mesh.update_kw())

    w.walk("optimizer", 1, optimizer)

    m = w.memory
    counts = {name: seg["count"] for name, seg in w.segments.items()}
    held = [n for n in m if n.startswith("layer_") or n == "cast"]
    kept = sum(counts[n] * m[n]["kept"] for n in held)
    # the embedding and the head run on top of every layer's kept bytes
    # and the cast tree; a layer's backward or the cast's on top of the
    # others' (its own kept bytes among its peak)
    work = max(m[n]["peak"] - (m[n]["kept"] if n in held else 0)
               for n in m if n != "optimizer")
    memory["activations"] = max(kept + work, m["optimizer"]["peak"])
    return _cell(w, memory, rows)


def serve_cell(cfg: ModelConfig, shape: ShapeSpec, data: int = 1,
               model: int = 1, rank: int = 0, head_mode: str = "reduced",
               walk: bool = True) -> dict:
    """Rank ``rank``'s prefill or decode step of ``shape`` (its kind) on
    a ``data x model`` mesh: segments (the head under both units,
    ``head_mode``'s in the total), totals, memory (``walk`` False: the
    trees' bytes alone)."""
    (params, batch, cache), local = steps.serve_specs(cfg, shape, data,
                                                      model, rank)
    memory = dict(params=tree_bytes(params), optimizer=0, gradients=0,
                  cache=tree_bytes(cache))
    if not walk:
        return _cell(None, memory, batch["tokens"].shape[0])
    group = lm.trunk_group(local)
    rows, S = batch["tokens"].shape
    dt = weights.dtype_of(cfg)
    prefill = shape.kind == "prefill"
    x_shape = (rows, S if prefill else 1, cfg.d_model)
    w = _Walks([None if local.shard is None else local.shard.group])
    src = batch.get("src_embeds")
    token = _empty((rows, 1), torch.int32)
    pos = _empty((), torch.int32)
    if prefill:
        consts = lm.embed_step(params, local, batch["tokens"],
                               batch.get("image_embeds"))[1]
    else:
        consts = lm.decode_constants(local, cache, pos, 1)
    x = _empty(x_shape, dt)
    enc_out = enc_x = enc_consts = None
    if src is not None:
        enc_out, enc_x = _empty(src.shape, dt), _empty(src.shape, dt)
        enc_consts = lm.encoder_input(local, src)[1]

    def embed(mark):
        if not prefill:
            return (lm.decode_constants(local, cache, pos, 1),
                    lm.embed_tokens(params, local, token))
        out = [lm.embed_step(params, local, batch["tokens"],
                             batch.get("image_embeds")),
               lm.init_cache(local, rows, S, "meta",
                             None if src is None else src.shape[1])]
        if src is not None:
            out += [lm.encoder_input(local, src),
                    lm.encoder_output(params, local, enc_x)]
        return out

    with torch.no_grad():
        w.walk("embed", 1, embed)

    def layer(kind: str, count: int):
        p = _fresh(_first_slot(params, cfg, kind), layer=True)
        if kind == "enc":
            def fn(mark):
                return lm.run_units([[[p]]], [(("enc",), 1)], enc_x, local,
                                    enc_consts, group)
        else:
            leaf = tree_mod.map_tree(      # a cache of one layer
                lambda _, a: _empty((1, *a.shape[1:]), a.dtype),
                _first_slot(cache, cfg, kind))
            if prefill:
                def fn(mark):
                    return lm.prefill_layer(p, x, local, kind, consts,
                                            group, enc_out, leaf, 0)
            else:
                def fn(mark):
                    return lm.decode_layer(p, x, local, kind, consts, group,
                                           leaf, 0)
        with torch.no_grad():
            w.walk(f"layer_{kind}", count, fn)

    for kind, count in layer_counts(cfg).items():
        layer(kind, count)
    if cfg.n_encoder_layers and prefill:
        layer("enc", cfg.n_encoder_layers)

    h_in = _empty((rows, 1, cfg.d_model), dt)
    for mode in HEAD_MODES:
        sampler = resolve(mode)

        def head(mark, sampler=sampler):
            h = lm.final_hidden(params, local, h_in)[:, 0, :]
            return sampler.head(params, local, h)

        with torch.no_grad():
            w.walk(f"head_{mode}", 1, head, accumulate=mode == head_mode)

    m = w.memory
    memory["activations"] = max(m[n]["peak"] - m[n]["end"] for n in m)
    return _cell(w, memory, rows)


def _cell(w: Optional[_Walks], memory: dict, rows: int) -> dict:
    """A cell's record: its rank's rows and bytes, and where ``w`` (the
    walks) is given the segments, their totals and their memory."""
    memory["total"] = sum(memory.values())
    out = dict(rows=rows, memory=memory)
    if w is not None:
        out.update(segments=w.segments, totals=w.total.as_dict(),
                   segment_memory=w.memory)
    return out


# ---------------------------------------------------------------------------
# Whole-step walks (smoke size: every layer dispatched)
# ---------------------------------------------------------------------------
def train_step_walk(cfg: ModelConfig, opt_cfg, shape: ShapeSpec,
                    data: int = 1, model: int = 1, rank: int = 0):
    """The rank's whole training step -- ``steps.loss_and_grads`` and
    ``optimizer.update``, the step's host parts left out -- walked at
    once: (``RooflineTerms``, ``Counter``)."""
    state, batch, mesh = steps.train_specs(cfg, opt_cfg, shape, data, model,
                                           rank)
    with hlo_stats.Counter() as c:
        loss, grads = steps.loss_and_grads(state["params"], mesh.cfg, batch,
                                           mesh)
        opt_mod.update(opt_cfg, grads, state["opt"], state["params"],
                       **mesh.update_kw())
    return hlo_stats.terms(c, _sum_bytes([mesh.data, mesh.model,
                                          mesh.kv])), c


def serve_step_walk(cfg: ModelConfig, shape: ShapeSpec, data: int = 1,
                    model: int = 1, rank: int = 0,
                    head_mode: str = "reduced"):
    """The rank's whole prefill (``steps.make_prefill_step``) or decode
    step (``steps.make_decode_step`` over the dense cache) walked at
    once: (``RooflineTerms``, ``Counter``)."""
    (params, batch, cache), local = steps.serve_specs(cfg, shape, data,
                                                      model, rank)
    rows = batch["tokens"].shape[0]
    with torch.no_grad(), hlo_stats.Counter() as c:
        if shape.kind == "prefill":
            steps.make_prefill_step(local, shape.seq_len, head_mode)(
                params, batch)
        else:
            steps.make_decode_step(local, head_mode)(
                params, _empty((rows, 1), torch.int32), cache,
                _empty((), torch.int32))
    return hlo_stats.terms(c, _sum_bytes(
        [None if local.shard is None else local.shard.group])), c


def _sum_bytes(groups) -> Dict[str, int]:
    """The bytes by kind ``groups`` (None for an axis of 1) counted."""
    out: Dict[str, int] = {}
    for g in groups:
        for k, n in (g.bytes if g is not None else {}).items():
            out[k] = out.get(k, 0) + n
    return out


# ---------------------------------------------------------------------------
# Analytic useful FLOPs (MODEL_FLOPS)
# ---------------------------------------------------------------------------
def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6*N*D (train) / 2*N per token (serve), N = active matmul params,
    plus attention score/output FLOPs."""
    n_active = cfg.active_param_count()
    # input embedding is a gather, not a matmul; tied heads still matmul
    n_mat = n_active - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 1)
    if cfg.tie_embeddings:
        n_mat += cfg.vocab_size * cfg.d_model  # head matmul happens anyway
    tokens = shape.global_batch * shape.seq_len
    n_attn = per_layer_attn_count(cfg) + cfg.n_encoder_layers + (
        cfg.n_layers if cfg.n_encoder_layers else 0)  # cross-attn
    w = cfg.attention_window
    if shape.kind == "train":
        s_avg = shape.seq_len / 2 if w is None else min(shape.seq_len / 2, w)
        attn = 12.0 * tokens * s_avg * cfg.q_width * n_attn
        return 6.0 * tokens * n_mat + attn
    if shape.kind == "prefill":
        s_avg = shape.seq_len / 2 if w is None else min(shape.seq_len / 2, w)
        attn = 4.0 * tokens * s_avg * cfg.q_width * n_attn
        return 2.0 * tokens * n_mat + attn
    # decode: one token per sequence against an S-entry cache
    s_kv = shape.seq_len if w is None else min(shape.seq_len, w)
    attn = 4.0 * shape.global_batch * s_kv * cfg.q_width * n_attn
    return 2.0 * shape.global_batch * n_mat + attn
