"""The train step and the train state's structure
(``repro.launch.steps``' training half), on one device or on a (data,
model) mesh of ranks.

The reference's lowering half has a counterpart for the dry-run
(``launch.dryrun``), which walks one rank's step on the ``meta`` device
instead of lowering a program: ``make_prefill_step`` /
``make_decode_step`` (``models.api``'s serving steps with one head),
``train_specs`` / ``serve_specs`` (one rank's state, batch and cache on
``meta`` under ``sharding.train_plan`` / ``sharding.plan``, cut by
``sharding.shard_leaf``, its rows of the global batch), and
``serve_structs`` (the whole model's).  Their groups are
``comm.CountingGroup``s (``counting_mesh``): no process group, the
collectives' bytes counted.

On a mesh (``TrainMesh``, ``make_mesh``) the reference's pjit over
``train_specs`` becomes one process a rank over ``parallel.comm``
groups: the model group runs the Megatron split forward and backward
(``comm.copy_to_group`` / ``reduce_from_group`` in ``models.lm`` and the
family blocks, ``comm.sum_to_group`` / ``gather_from_group`` in RWKV6's
channel-mix, the vocabulary-parallel loss in ``models.api``), each
rank of the data group on its block of the batch's rows.  At D > 1 the
data group cuts the weights too (FSDP, ``sharding.data_cut``): each
rank holds its 1/D of every leaf the reference cuts over ``data`` --
the f32 masters, AdamW's moments and the gradients -- gathers each
unit's cut leaves in the compute dtype as the unit runs (kind
``"fsdp"``; ``comm.gather_shards``) and reduce-scatters their
gradients in f32 (kind ``"grad"``) in the backward; the leaves the
reference keeps whole over ``data`` (the norms, RWKV6's mixing
coefficients, the RG-LRU's channel leaves) stay replicas.  After the
backward a rank's gradients are completed (``complete_grads``): the
qk-norm scales' parts summed over the model group (kind ``"norm"``) and
the router's (kind ``"router"``: its combine weights' part plus its 1 /
M share of the router loss's), a copied kv head's wk / wv summed over
the ranks that hold the copy (kind ``"kv"``, the ``kv`` group), then
every data-replicated leaf summed over the data group in f32 (kind
``"grad"``), leaf by leaf in the tree's order on every rank -- each
rank's loss is its share of the global mean (``api.xent_loss``, and the
router loss's share over the global counts), so the sum (the
reduce-scatter's too) is the mean's gradient, the reference's plain
reduction over ``data`` (its loop never compresses it;
``optim.compression.compressed_psum`` stays unwired, as there).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree as tree_mod
from repro_torch import weights
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.optim import optimizer as opt_mod
from repro_torch.parallel import comm, sharding


@dataclasses.dataclass
class TrainMesh:
    """One rank's place in a (data, model) mesh: its ``plan``
    (``sharding.train_plan``: its model ``split`` and its data cut
    ``dcut``), its data and model groups (None on an axis of 1), the
    whole config ``full`` and the rank's view ``cfg``
    (``sharding.local_config`` under a split model axis), the rank's
    ``device``, and ``kv``, the ranks of its data index that hold the
    same copy of a kv head (None where the kv heads split evenly)."""

    plan: sharding.TrainPlan
    data: Optional[comm.Group]
    model: Optional[comm.Group]
    full: ModelConfig
    cfg: ModelConfig
    device: torch.device
    kv: Optional[comm.Group] = None

    @property
    def split(self) -> Optional[sharding.Split]:
        return self.plan.split

    @property
    def dcut(self) -> Optional[sharding.DataCut]:
        return self.plan.dcut

    def shard(self, tree):
        """The rank's cut of a whole tree (params or a train state): its
        model slice, then its data index's 1/D of the data-cut leaves."""
        if self.split is None and self.dcut is None:
            return tree
        return weights.shard_params(tree, self.full, self.split, self.dcut)

    def gather(self, tree, kind: str = "gather"):
        """A rank's cut of a tree put back into the whole layout:
        collective over the data group, then the model group."""
        return sharding.gather_tree(tree, self.full, self.split, kind,
                                    self.dcut)

    def split_leaf(self, path: tuple) -> bool:
        """Whether the model axis cuts the leaf at ``path``."""
        return sharding.split_axis(path, self.full, self.split) is not None

    def data_axis(self, path: tuple) -> Optional[int]:
        """The axis the data axis cuts the leaf at ``path`` along, or None
        for a leaf each rank of the data group holds whole."""
        return None if self.dcut is None else self.dcut.axis(path)

    def duplicate_leaf(self, path: tuple) -> bool:
        """Whether the rank's slice at ``path`` is a kv copy that a lower
        model rank holds too (the global norm counts it there alone)."""
        return (self.kv is not None and self.kv.rank > 0
                and sharding.kv_copy_leaf(path))

    def update_kw(self) -> dict:
        """``optimizer.update``'s arguments for the rank's cut: the model
        group's split leaves and kv copies, the data group's cut
        leaves."""
        kw = {}
        if self.model is not None:
            kw.update(model=self.model, split_leaf=self.split_leaf,
                      skip_leaf=self.duplicate_leaf)
        if self.data is not None:
            kw.update(data=self.data, data_axis=self.data_axis)
        return kw


def parse_mesh(mesh: Optional[str]):
    """``"DxM"`` -> (D, M); None -> (1, 1)."""
    if mesh is None:
        return 1, 1
    try:
        d, m = (int(x) for x in mesh.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {mesh!r}: expected DxM, e.g. 2x2") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {mesh!r}: both axes must be >= 1")
    return d, m


def make_mesh(cfg: ModelConfig, group: comm.Group, data: int,
              model: int) -> TrainMesh:
    """This rank's ``TrainMesh`` of ``data x model`` ranks over ``group``
    (whose world must be ``data * model``): the groups
    (``comm.mesh_groups``), then the plan.  Collective: every rank of
    ``group`` calls it."""
    if data * model != group.world:
        raise ValueError(f"a mesh of {data}x{model} needs {data * model} "
                         f"ranks; the world has {group.world}")
    # refuse a config before any group is made
    sharding.train_plan(cfg, group.rank, data, model)
    dgroup, mgroup = comm.mesh_groups(group, data, model)
    plan = sharding.train_plan(cfg, group.rank, data, model, group=mgroup,
                               data_group=dgroup)
    local = cfg if plan.split is None else sharding.local_config(
        cfg, plan.split)
    kv = None
    copies = sharding.kv_copies(cfg, model)
    if copies is not None:
        # the same model indices' set in every data index, made in one
        # order on every rank
        kv = group.split_sets([[d * model + m for m in ms]
                               for d in range(data) for ms in copies])
    return TrainMesh(plan, dgroup, mgroup, cfg, local, group.device, kv)


def rank_grads(params, cfg: ModelConfig, batch: dict, *, data=None,
               dcut=None):
    """(loss, grads) of this rank alone: ``api.train_loss`` and its
    gradient in every leaf of ``params`` (a tree of the f32 masters,
    which need not require grad: the loss is taken on detached views of
    them, so the masters stay plain tensors an optimizer updates in place
    and an engine serves).  A leaf the loss does not reach gets zeros, as
    ``jax.grad`` gives.  On a mesh ``cfg`` is the rank's view, ``data``
    its data group and ``dcut`` its data cut; the qk-norm scales'
    gradients are then this rank's parts, the loss its share
    (``complete_grads``), and a data-cut leaf's gradient the data
    group's sum already (reduce-scattered in the backward)."""
    live = [p.detach().requires_grad_(True) for p in tree_mod.leaves(params)]
    loss = api.train_loss(tree_mod.unflatten(params, live), cfg, batch,
                          data=data, dcut=dcut)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), tree_mod.unflatten(params, grads)


def complete_grads(loss, grads, mesh: Optional[TrainMesh]):
    """A rank's (loss share, gradients) made whole, in place: the
    replicated leaves whose gradient is a part on each model rank
    (``sharding.partial_grad``: the qk-norm scales, kind ``"norm"``; the
    router, kind ``"router"``) summed over the model group, a copied kv
    head's wk / wv over the ranks holding the copy (kind ``"kv"``), then
    every data-replicated leaf and the loss summed over the data group
    in f32, leaf by leaf in the tree's order (a data-cut leaf's gradient
    was reduce-scattered over it in the backward, never all-reduced).
    Returns (loss, grads)."""
    if mesh is None:
        return loss, grads
    if mesh.model is not None:
        for path, g in tree_mod.items(grads):
            if sharding.partial_grad(path):
                mesh.model.all_reduce_sum(
                    g, "router" if path[-1] == "router" else "norm")
            elif mesh.kv is not None and sharding.kv_copy_leaf(path):
                mesh.kv.all_reduce_sum(g, "kv")
    if mesh.data is not None:
        for path, g in tree_mod.items(grads):
            if mesh.data_axis(path) is None:
                mesh.data.all_reduce_sum(g, "grad")
        loss = mesh.data.all_reduce_sum(loss.float().reshape(1), "loss")[0]
    return loss, grads


def loss_and_grads(params, cfg: ModelConfig, batch: dict,
                   mesh: Optional[TrainMesh] = None):
    """(loss, grads): ``rank_grads``, then on a mesh ``complete_grads``
    (``cfg`` is then ``mesh.cfg``): the global batch's loss and the
    gradient of the rank's slice of the masters."""
    loss, grads = rank_grads(params, cfg, batch,
                             data=None if mesh is None else mesh.data,
                             dcut=None if mesh is None else mesh.dcut)
    return complete_grads(loss, grads, mesh)


def digest(tree) -> int:
    """A signed 64-bit digest of every tensor leaf's bits (each leaf's
    words summed as int64, folded in the tree's order): equal trees give
    equal digests on every rank."""
    h = 0
    for leaf in tree_mod.leaves(tree):
        t = leaf.detach().contiguous().reshape(-1)
        words = t.view(torch.int16 if t.element_size() == 2 else
                       torch.int32 if t.element_size() == 4 else
                       torch.int64)
        s = int(words.sum(dtype=torch.int64))
        h = (h * 1_000_003 + s) & (2 ** 64 - 1)
    return h - 2 ** 64 if h >= 2 ** 63 else h


def check_replicas(mesh: TrainMesh, params, when: str) -> None:
    """Raise on every rank unless the ranks of each data group hold the
    same bits of the leaves the data axis replicates (those it does not
    cut: the norms and the like), and the ranks of each model group the
    same bits of the leaves it replicates: ``comm.Group.agree`` on a
    digest."""
    if mesh.data is not None:
        rep = [leaf for path, leaf in tree_mod.items(params)
               if mesh.data_axis(path) is None]
        mesh.data.agree(digest(rep), f"the data group's replicated "
                        f"masters {when}")
    if mesh.model is not None:
        rep = [leaf for path, leaf in tree_mod.items(params)
               if not mesh.split_leaf(path)]
        mesh.model.agree(digest(rep), f"the model group's replicated "
                         f"leaves {when}")
    if mesh.kv is not None:
        kv = [leaf for path, leaf in tree_mod.items(params)
              if sharding.kv_copy_leaf(path)]
        mesh.kv.agree(digest(kv), f"the copied kv heads {when}")


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig,
                    mesh: Optional[TrainMesh] = None, on_grads=None):
    """``step(state, batch) -> (state, metrics)``: loss and gradients
    (``loss_and_grads``), then ``optimizer.update``, which writes
    ``state["params"]`` and ``state["opt"]`` in place; the metrics are
    ``loss``, ``grad_norm`` and ``lr``, f32 scalars on the device (read
    them with ``float``, which waits for the step).

    ``mesh``: the step of a rank (``cfg`` is then ``mesh.cfg``, the
    state the rank's cut, the batch its rows); the global norm sums the
    split leaves over the model group, each copied kv head once, and
    the data-cut leaves over the data group; before the first update and
    after it every replica is checked to hold the same bits
    (``check_replicas``).

    ``on_grads(grads)``, where given, sees each step's gradients once
    they are whole (on a mesh the rank's slice), before the update reads
    them."""
    if mesh is not None:
        opt_mod.check_split(opt_cfg, mesh.model is not None)
    first = [mesh is not None]

    def train_step(state: dict, batch: dict):
        if first[0]:
            check_replicas(mesh, state["params"], "at start")
        loss, grads = loss_and_grads(state["params"], cfg, batch, mesh)
        if on_grads is not None:
            on_grads(grads)
        kw = {} if mesh is None else mesh.update_kw()
        metrics = opt_mod.update(opt_cfg, grads, state["opt"],
                                 state["params"], **kw)
        if first[0]:
            check_replicas(mesh, state["params"], "after the first step")
            first[0] = False
        return state, dict(metrics, loss=loss)

    return train_step


def train_state_struct(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig):
    """The train state's tree on the ``meta`` device (shapes and dtypes,
    no memory): the port's ``jax.eval_shape``, the target of
    ``CheckpointManager.restore``."""
    params = api.params_struct(cfg)
    return {"params": params, "opt": opt_mod.init_state(opt_cfg, params)}


# ---------------------------------------------------------------------------
# The dry-run's half (reference ``launch/steps.py:39-101``): serving steps
# with one head, and one rank's trees on ``meta``
# ---------------------------------------------------------------------------
def make_prefill_step(cfg: ModelConfig, max_len: int,
                      head_mode: str = "reduced"):
    """``prefill_step(params, batch) -> (head output, cache)``:
    ``api.serve_prefill`` of ``batch["tokens"]`` (and a vlm / encdec
    config's stub embeddings) at ``max_len`` with the ``head_mode``
    sampler."""
    from repro_torch.serve.sampler import resolve

    sampler = resolve(head_mode)

    def prefill_step(params, batch):
        return api.serve_prefill(params, cfg, batch["tokens"], max_len,
                                 sampler,
                                 image_embeds=batch.get("image_embeds"),
                                 src_embeds=batch.get("src_embeds"))

    return prefill_step


def make_decode_step(cfg: ModelConfig, head_mode: str = "reduced"):
    """``decode_step(params, token, cache, pos) -> (head output,
    cache)``: ``api.serve_decode`` over a dense cache, written in
    place."""
    from repro_torch.serve.sampler import resolve

    sampler = resolve(head_mode)

    def decode_step(params, token, cache, pos):
        return api.serve_decode(params, cfg, token, cache, pos, sampler)

    return decode_step


def rank_rows(global_batch: int, data: int, train: bool) -> int:
    """A data rank's rows: ``global_batch / data``.  A serving batch that
    does not divide is held whole on every data rank, as the reference's
    ``batch_axes`` drops the data axis then; training raises."""
    if global_batch % data == 0:
        return global_batch // data
    if train:
        raise ValueError(f"a global batch of {global_batch} rows does not "
                         f"divide over a data axis of {data}")
    return global_batch


def counting_mesh(cfg: ModelConfig, data: int = 1, model: int = 1,
                  rank: int = 0) -> TrainMesh:
    """Rank ``rank``'s ``TrainMesh`` of ``data x model`` ranks over
    ``comm.CountingGroup``s (``make_mesh``'s layout, on ``meta``): raises
    where ``sharding.train_plan`` refuses the config."""
    plan = sharding.train_plan(cfg, rank, data, model)
    mgroup = comm.CountingGroup(plan.m, model) if model > 1 else None
    dgroup = comm.CountingGroup(plan.d, data) if data > 1 else None
    plan = sharding.train_plan(cfg, rank, data, model, group=mgroup,
                               data_group=dgroup)
    local = cfg if plan.split is None else sharding.local_config(
        cfg, plan.split)
    kv = None
    for ms in sharding.kv_copies(cfg, model) or ():
        if plan.m in ms:
            kv = comm.CountingGroup(ms.index(plan.m), len(ms))
    return TrainMesh(plan, dgroup, mgroup, cfg, local, torch.device("meta"),
                     kv)


def rank_tree(tree, cfg: ModelConfig, split: Optional[sharding.Split],
              dcut: Optional[sharding.DataCut] = None):
    """A rank's cut of a whole ``meta`` tree: each leaf a fresh contiguous
    ``meta`` tensor of ``sharding.shard_leaf``'s shape (as
    ``weights.shard_params`` makes the rank's leaves contiguous)."""
    if split is None and dcut is None:
        return tree
    return tree_mod.map_tree(
        lambda path, a: torch.empty(
            sharding.shard_leaf(path, a, cfg, split, dcut).shape,
            dtype=a.dtype, device="meta"), tree)


def train_specs(cfg: ModelConfig, opt_cfg: opt_mod.AdamWConfig, shape,
                data: int = 1, model: int = 1, rank: int = 0):
    """(state, batch, mesh) of rank ``rank`` training ``shape`` on a
    ``data x model`` mesh, on ``meta``: the f32 masters' cut (model and
    data) and its AdamW state, the rank's ``global_batch / data`` rows,
    and its ``counting_mesh`` (``mesh.cfg`` the rank's view)."""
    mesh = counting_mesh(cfg, data, model, rank)
    opt_mod.check_split(opt_cfg, mesh.model is not None)
    params = rank_tree(api.params_struct(cfg), cfg, mesh.split, mesh.dcut)
    state = {"params": params, "opt": opt_mod.init_state(opt_cfg, params)}
    rows = rank_rows(shape.global_batch, data, train=True)
    return state, api.batch_struct(cfg, shape, rows), mesh


def serve_structs(cfg: ModelConfig, shape):
    """(params, batch, cache) of the whole model serving ``shape`` on
    ``meta``: the weights in the compute dtype, as serving stores them
    (``weights.cast_params``: no f32 master copy, reference :78-90), the
    batch without labels, the dense decode cache (``api.cache_struct``)
    at ``shape.seq_len``."""
    params = weights.cast_params(api.params_struct(cfg), cfg)
    batch = api.batch_struct(cfg, shape)
    batch.pop("labels", None)
    cache = api.cache_struct(cfg, shape.global_batch, shape.seq_len)
    return params, batch, cache


def serve_specs(cfg: ModelConfig, shape, data: int = 1, model: int = 1,
                rank: int = 0):
    """((params, batch, cache), local cfg) of rank ``rank`` serving
    ``shape`` on a ``data x model`` mesh, on ``meta``: the model axis a
    tensor-parallel group (``sharding.plan``, which raises where the
    heads, widths, experts or vocabulary do not divide; the rank's
    ``CountingGroup`` on its split), the data axis replicas, each on
    ``rank_rows`` of the batch; the cache at the rank's kv heads and
    recurrent channels."""
    local, split = cfg, None
    if model > 1:
        m = rank % model
        split = sharding.plan(cfg, m, model,
                              group=comm.CountingGroup(m, model))
        local = sharding.local_config(cfg, split)
    params = weights.cast_params(
        rank_tree(api.params_struct(cfg), cfg, split), cfg)
    rows = rank_rows(shape.global_batch, data, train=False)
    batch = api.batch_struct(cfg, shape, rows)
    batch.pop("labels", None)
    cache = api.cache_struct(local, rows, shape.seq_len)
    return (params, batch, cache), local
