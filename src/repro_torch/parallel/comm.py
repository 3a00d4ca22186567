"""Process groups for tensor-parallel serving: one process per shard.

Counterpart of ``repro.parallel.env`` and ``repro.launch.mesh``.  The JAX
package drives a device mesh from one process; the port runs one process
per rank (SPMD) with the collectives outside the kernels, over
``torch.distributed``.  A ``Group`` is one rank's handle:

  rank, world    this process's place in the group
  device         ``cuda:(LOCAL_RANK % device_count)`` on the card, or the
                 CPU (``device="cpu"``, as the tests run)
  backend        the data collectives' backend: ``nccl`` where every rank
                 on the host has a card of its own, else ``gloo`` (which
                 takes CUDA tensors and stages them through the host: on
                 one card, several ranks share it over gloo)

Collectives: ``all_gather`` (stacked along a new leading rank axis),
``all_reduce_sum`` (in place), ``reduce_scatter_sum`` (the sum over the
ranks, each rank keeping its 1/world of one axis; over gloo a card's
tensors are staged through the host, as ``send`` / ``recv`` stage
theirs), ``broadcast_object`` (a pickled object
from rank 0 over a separate CPU gloo group, the control plane, so host
messages never queue behind device traffic) and ``gather_object`` (every
rank's object on rank 0, over the same group).  ``agree`` all-gathers
one int64 per rank over that control group and raises when they differ.

``split(size)`` cuts a group into groups of ``size`` consecutive ranks
(``torch.distributed.new_group``, a data group and a control group
each): the rank groups of ``serve.router.Router(tp=)``, one a replica,
whose collectives never involve another replica's ranks.
``split_strided(stride)`` cuts it into the groups ``{i + k * stride}``:
with ``split(M)`` the model groups of a (data, model) mesh of D x M
ranks, ``split_strided(M)`` gives its data groups, rank ``r``'s being
``{r mod M + k * M}`` (``mesh_groups``).  ``split_sets`` cuts it into
any sets (a mesh's ranks holding one copy of a kv head).  Every
collective of a group waits at most its ``timeout_s``.

``CountingGroup`` is a group with no process behind it, for the
dry-run's walk of one rank on the ``meta`` device: its collectives
return tensors of the right shapes and count their bytes as a
``Group``'s do.

Under autograd a collective needs its own derivative.  The Megatron pair
(``copy_to_group``, ``reduce_from_group``) is two
``torch.autograd.Function``s: ``copy_to_group`` is the identity forward
and all-reduces the gradient backward (at every column-parallel input:
each rank's heads or columns give a part of the input's gradient);
``reduce_from_group`` all-reduces forward and passes the gradient on as
it is backward (at every row-parallel output and the vocabulary-sharded
embedding lookup).  Beside them, for sums and gathers whose ranks do NOT
all use the whole result: ``sum_to_group`` all-reduces both ways (each
rank reads only its part of the sum, RWKV6's channel-mix ``kv``), and
``gather_from_group`` all-gathers forward and hands each rank its own
slice of the gradient backward (everything after the gather is the same
on every rank).  ``share_grad`` is the identity forward and divides the
gradient by the group's size backward: a term every rank computes whole
from replicated inputs (the MoE router loss), whose gradient the model
group's sums would otherwise count ``world`` times.  Without grad each
is the in-place serving collective or nothing, so serving's numbers and
bytes do not move.

FSDP over a training mesh's data group (``parallel.sharding.data_cut``)
holds a leaf as a ``Shard``: the rank's f32 cut, its axis, the group
and the compute dtype.  ``Shard[l]`` is layer ``l``'s cut of a stacked
leaf, and ``Shard.whole()`` is ``gather_shards``: the cut cast to the
compute dtype and all-gathered along its axis forward (kind
``"fsdp"``), the gradient upcast to f32 and reduce-scattered backward
(kind ``"grad"``) -- the cast the replicated layout made at the top of
the step, and the f32 sum over the data group it made after the
backward.

``bytes`` counts the bytes every collective left on this rank, by the
kind its caller names (``"trunk"``, ``"embed"``, ``"head"``,
``"logits"``, ``"control"``, ``"digest"``; in training also ``"loss"``,
``"grad"``, ``"norm"``, ``"router"``, ``"kv"``, ``"aux"`` and
``"cross"``, the encoder output's gradient, ``"fsdp"``, a data-cut
weight gathered, and ``"opt"``, a factored moment's means over a data
cut): an all-gather counts its whole result, an all-reduce its tensor,
a reduce-scatter its input.  It takes the place of the
reference's ``repro.launch.hlo_stats.collective_bytes`` over compiled
HLO, and is what shows the comparator head's traffic to be O(rows *
ranks * k), never O(rows * V).
"""
from __future__ import annotations

import datetime
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# the group's timeout when the caller names none: a rank that dies or
# diverges fails the others within it instead of hanging them
DEFAULT_TIMEOUT_S = 300.0


def rank_device(device, local_rank: int) -> torch.device:
    """The device rank ``local_rank`` of a host takes: ``cuda:(local_rank
    % device_count)`` for ``device="cuda"`` (raises without a card), the
    CPU for ``"cpu"``."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"device {device}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port's entry points run on the card "
            "(pass device='cpu' to run the plain kernel versions)")
    if device.index is not None:
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def pick_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` where each of the host's ranks has a card of its own (NCCL
    refuses two ranks of one communicator on one device), else ``gloo``."""
    if device.type == "cuda" and dist.is_nccl_available() \
            and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


class Group:
    """One rank's handle on a group of ranks; see the module docstring.
    Build it with ``Group.init`` (an explicit rendezvous) or
    ``Group.from_env`` (torchrun's environment)."""

    def __init__(self, rank: int, world: int, device: torch.device,
                 backend: str, control, *, data=None,
                 ranks: Optional[Sequence[int]] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.rank = rank
        self.world = world
        self.device = device
        self.backend = backend
        # the members' ranks in the default process group (a split
        # group's are a slice of it); ``data`` None is that default group
        self.ranks = tuple(range(world)) if ranks is None else tuple(ranks)
        self.timeout_s = float(timeout_s)
        self._data = data
        self._control = control
        self.bytes: Dict[str, int] = {}

    @classmethod
    def init(cls, rank: int, world: int, *, init_method: Optional[str] = None,
             store=None, device="cuda", local_rank: Optional[int] = None,
             local_world: Optional[int] = None,
             timeout_s: float = DEFAULT_TIMEOUT_S) -> "Group":
        """Join a group of ``world`` ranks as ``rank``: the default process
        group (``init_method``, e.g. ``file://<dir>/rdv`` or
        ``tcp://localhost:<port>``, or a ``store``) for the data
        collectives, plus a gloo group for the control plane."""
        local_rank = rank if local_rank is None else local_rank
        local_world = world if local_world is None else local_world
        dev = rank_device(device, local_rank)
        backend = pick_backend(dev, local_world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        kw = dict(backend=backend, rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=timeout_s))
        if store is not None:
            kw["store"] = store
        else:
            kw["init_method"] = init_method
        dist.init_process_group(**kw)
        control = dist.new_group(backend="gloo")
        return cls(rank, world, dev, backend, control, timeout_s=timeout_s)

    @classmethod
    def from_env(cls, device="cuda", **kw) -> "Group":
        """The group torchrun describes (RANK, WORLD_SIZE, LOCAL_RANK,
        LOCAL_WORLD_SIZE, MASTER_ADDR/PORT); without WORLD_SIZE, a group
        of one rank on an in-process store."""
        if "WORLD_SIZE" not in os.environ:
            return cls.init(0, 1, store=dist.HashStore(), device=device, **kw)
        world = int(os.environ["WORLD_SIZE"])
        return cls.init(int(os.environ["RANK"]), world, init_method="env://",
                        device=device,
                        local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                        local_world=int(os.environ.get("LOCAL_WORLD_SIZE",
                                                       world)), **kw)

    def split(self, size: int, *,
              timeout_s: Optional[float] = None) -> "Group":
        """This group cut into ``world // size`` groups of ``size``
        consecutive ranks; returns this rank's.  Every rank of the group
        calls it, in the same order (``new_group`` is collective over the
        default process group).  ``timeout_s`` defaults to this group's."""
        if size < 1 or self.world % size:
            raise ValueError(f"split({size}): a group of {self.world} ranks "
                             "does not cut into groups of that size")
        return self._subgroups([list(range(lo, lo + size))
                                for lo in range(0, self.world, size)],
                               timeout_s)

    def split_strided(self, stride: int, *,
                      timeout_s: Optional[float] = None) -> "Group":
        """This group cut into ``stride`` groups, group ``i`` the members
        ``i, i + stride, i + 2 * stride, ...``; returns this rank's.
        Called as ``split``."""
        if stride < 1 or self.world % stride:
            raise ValueError(f"split_strided({stride}): a group of "
                             f"{self.world} ranks does not cut so")
        return self._subgroups([list(range(i, self.world, stride))
                                for i in range(stride)], timeout_s)

    def split_sets(self, sets: List[List[int]], *,
                   timeout_s: Optional[float] = None) -> "Group":
        """This group cut into ``sets`` (members' indices, every member in
        one set; the copied kv heads' groups of a mesh); returns this
        rank's.  Called as ``split``."""
        return self._subgroups(sets, timeout_s)

    def _subgroups(self, sets: List[List[int]],
                   timeout_s: Optional[float]) -> "Group":
        """A data and a control group for each of ``sets`` (members'
        indices in this group, every member in one set), made in the
        order given on every rank; returns this rank's."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        td = datetime.timedelta(seconds=timeout_s)
        mine = None
        for members in sets:
            ranks = [self.ranks[i] for i in members]
            data = dist.new_group(ranks, timeout=td, backend=self.backend)
            control = dist.new_group(ranks, timeout=td, backend="gloo")
            if self.rank in members:
                mine = Group(members.index(self.rank), len(members),
                             self.device, self.backend, control, data=data,
                             ranks=ranks, timeout_s=timeout_s)
        return mine

    def close(self) -> None:
        """Leave the default process group, and with it every group split
        from it."""
        if dist.is_initialized():
            dist.destroy_process_group()

    def _count(self, kind: str, n: int) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0) + int(n)

    def all_gather(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """Every rank's ``x`` stacked in rank order: (world, *x.shape)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        dist.all_gather(parts, x, group=self._data)
        out = torch.stack(parts)
        self._count(kind, out.numel() * out.element_size())
        return out

    def all_reduce_sum(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """Sum ``x`` over the ranks, in place; returns ``x``.  Every rank
        gets the same bits."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self._data)
        self._count(kind, x.numel() * x.element_size())
        return x

    def reduce_scatter_sum(self, x: torch.Tensor, axis: int,
                           kind: str) -> torch.Tensor:
        """The sum of the ranks' ``x`` (whose ``axis`` divides by the
        world), this rank's ``1 / world`` of it along ``axis``, in rank
        order: a new contiguous tensor.  Over gloo a card's tensor goes
        through the host."""
        if x.shape[axis] % self.world:
            raise ValueError(f"reduce_scatter_sum: axis {axis} of "
                             f"{tuple(x.shape)} does not divide by the "
                             f"world {self.world}")
        host = self._staged(x)
        src = x.cpu() if host else x
        parts = [p.contiguous() for p in src.chunk(self.world, dim=axis)]
        out = torch.empty_like(parts[self.rank])
        dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM,
                            group=self._data)
        self._count(kind, x.numel() * x.element_size())
        return out.to(x.device) if host else out

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` on every rank (pickled, over the control
        group)."""
        box = [obj if self.rank == src else None]
        dist.broadcast_object_list(box, src=self.ranks[src],
                                   group=self._control)
        self._count("control", len(pickle.dumps(box[0])))
        return box[0]

    def gather_object(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's ``obj`` in rank order on rank 0, None elsewhere
        (pickled, over the control group)."""
        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=self.ranks[0], group=self._control)
        self._count("control", len(pickle.dumps(obj)))
        return out

    def agree(self, value: int, what: str) -> None:
        """All-gather one int64 per rank over the control group; raise
        ``RuntimeError`` on every rank when they are not all equal, so a
        divergence fails the group at once instead of deadlocking a later
        collective or corrupting the KV cache without a word."""
        mine = torch.tensor([value], dtype=torch.int64)
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine, group=self._control)
        self._count("digest", 8 * self.world)
        got = [int(p) for p in parts]
        if len(set(got)) > 1:
            raise RuntimeError(
                f"ranks diverged at {what}: rank digests {got} (rank "
                f"{self.rank} of {self.world})")

    def _staged(self, x: torch.Tensor) -> bool:
        """Whether ``x`` goes through the host: gloo's point-to-point ops
        and its reduce-scatter take host tensors only (its other
        collectives stage a card's tensors themselves)."""
        return self.backend == "gloo" and x.device.type != "cpu"

    def send(self, x: torch.Tensor, dst: int, kind: str) -> None:
        """``x`` to member ``dst`` of this group (point to point)."""
        t = x.contiguous()
        dist.send(t.cpu() if self._staged(t) else t, self.ranks[dst],
                  group=self._data)
        self._count(kind, x.numel() * x.element_size())

    def recv(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Member ``src``'s tensor into ``x`` (its shape and dtype);
        returns ``x``."""
        buf = torch.empty(x.shape, dtype=x.dtype) if self._staged(x) else x
        dist.recv(buf, self.ranks[src], group=self._data)
        if buf is not x:
            x.copy_(buf)
        return x

    def broadcast(self, x: torch.Tensor, src: int, kind: str) -> torch.Tensor:
        """Member ``src``'s ``x`` into every member's ``x``, in place."""
        buf = x.cpu() if self._staged(x) else x
        dist.broadcast(buf, self.ranks[src], group=self._data)
        if buf is not x:
            x.copy_(buf)
        self._count(kind, x.numel() * x.element_size())
        return x

    def __repr__(self) -> str:
        return (f"Group(rank={self.rank}, world={self.world}, "
                f"device={self.device}, backend={self.backend!r})")


class CountingGroup(Group):
    """A ``Group`` stand-in for the dry-run's walk on ``meta``
    (``launch.dryrun``): rank ``rank`` of ``world`` with no process group
    behind it.  ``all_gather`` returns a ``meta`` tensor of the stacked
    shape, ``all_reduce_sum`` and ``broadcast`` return their ``x``,
    ``reduce_scatter_sum`` a ``meta`` tensor of the rank's part,
    ``send`` sends nothing and ``recv`` returns its ``x``; each adds to
    ``bytes`` by kind exactly what ``Group``'s does, so a rank's real
    step code runs over it -- the vocabulary-parallel loss and expert
    parallelism included -- and leaves the traffic its groups would
    carry.  Anything that needs other ranks' values (``agree``,
    ``broadcast_object``, ``split``) is not overridden and fails."""

    def __init__(self, rank: int, world: int):
        super().__init__(rank, world, torch.device("meta"), "counting",
                         None)

    def all_gather(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        out = x.new_empty((self.world, *x.shape))
        self._count(kind, out.numel() * out.element_size())
        return out

    def all_reduce_sum(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        self._count(kind, x.numel() * x.element_size())
        return x

    def broadcast(self, x: torch.Tensor, src: int, kind: str) -> torch.Tensor:
        self._count(kind, x.numel() * x.element_size())
        return x

    def reduce_scatter_sum(self, x: torch.Tensor, axis: int,
                           kind: str) -> torch.Tensor:
        self._count(kind, x.numel() * x.element_size())
        return x.chunk(self.world, dim=axis)[self.rank].contiguous()

    def send(self, x: torch.Tensor, dst: int, kind: str) -> None:
        self._count(kind, x.numel() * x.element_size())

    def recv(self, x: torch.Tensor, src: int) -> torch.Tensor:
        return x


def mesh_groups(group: Group, data: int, model: int):
    """(data group, model group) of this rank in a (data, model) mesh of
    ``data x model`` ranks over ``group``: the model groups are ``model``
    consecutive ranks, rank ``r`` at model index ``r % model`` of the
    data index ``r // model``; the data groups ``{r mod model + k *
    model}``.  A mesh axis of size 1 gives None.  Every rank calls it, in
    the same order."""
    if data < 1 or model < 1 or data * model != group.world:
        raise ValueError(f"a mesh of {data}x{model} needs {data * model} "
                         f"ranks; the group has {group.world}")
    mgroup = group.split(model) if model > 1 else None
    dgroup = group.split_strided(model) if data > 1 else None
    return dgroup, mgroup


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum(g.contiguous().clone(),
                                        ctx.kind), None, None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward (into a new tensor); the gradient
    passed on as it is."""

    @staticmethod
    def forward(ctx, x, group, kind):
        return group.all_reduce_sum(x.contiguous().clone(), kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_group(x: torch.Tensor, group: Optional[Group],
                  kind: str) -> torch.Tensor:
    """A column-parallel layer's input: ``x`` itself forward; under
    autograd its gradient is summed over ``group`` (each rank's columns
    give a part of it).  ``group`` None: ``x``."""
    if group is None or not _tracked(x):
        return x
    return _CopyToGroup.apply(x, group, kind)


def reduce_from_group(x: torch.Tensor, group: Optional[Group],
                      kind: str) -> torch.Tensor:
    """A row-parallel layer's output: the sum of the ranks' ``x``; under
    autograd the gradient goes to every rank's ``x`` whole.  Without
    grad the sum is in place (``Group.all_reduce_sum``), as serving has
    it.  ``group`` None: ``x``."""
    if group is None:
        return x
    if not _tracked(x):
        return group.all_reduce_sum(x, kind)
    return _ReduceFromGroup.apply(x, group, kind)


class _SumToGroup(torch.autograd.Function):
    """The sum over the group forward (into a new tensor); the gradient
    summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return group.all_reduce_sum(x.contiguous().clone(), kind)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum(g.contiguous().clone(),
                                        ctx.kind), None, None


class _GatherFromGroup(torch.autograd.Function):
    """Every rank's ``x`` stacked in rank order forward; the rank's own
    slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.rank = group.rank
        return group.all_gather(x, kind)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None, None


class _ShareGrad(torch.autograd.Function):
    """Identity forward; the gradient divided by ``n`` backward."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def sum_to_group(x: torch.Tensor, group: Optional[Group],
                 kind: str) -> torch.Tensor:
    """The sum of the ranks' ``x`` where each rank goes on to read only
    its own part of it: under autograd the gradient of each rank's ``x``
    is the sum of the ranks' gradients of the sum (another rank's part
    of the sum holds this rank's ``x`` too).  Without grad, in place, as
    ``reduce_from_group``.  ``group`` None: ``x``."""
    if group is None:
        return x
    if not _tracked(x):
        return group.all_reduce_sum(x, kind)
    return _SumToGroup.apply(x, group, kind)


def gather_from_group(x: torch.Tensor, group: Group,
                      kind: str) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, (world, *x.shape)
    (``Group.all_gather``); under autograd the gradient of the rank's
    ``x`` is its own slice of the stack's gradient, which is right where
    everything after the gather is the same on every rank."""
    if not _tracked(x):
        return group.all_gather(x, kind)
    return _GatherFromGroup.apply(x, group, kind)


def share_grad(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """``x`` itself; under autograd its gradient divided by the group's
    size, so a term every rank of ``group`` computes whole counts once
    once its gradients are summed over the group (the reference's
    ``pmean`` of the MoE router loss over ``model``).  ``group`` None:
    ``x``."""
    if group is None or not _tracked(x):
        return x
    return _ShareGrad.apply(x, float(group.world))


class _GatherShards(torch.autograd.Function):
    """A rank's f32 cut cast to ``dtype`` and all-gathered along ``axis``
    forward; the gradient upcast to f32 and reduce-scattered along it
    backward."""

    @staticmethod
    def forward(ctx, x, group, axis, dtype):
        ctx.group, ctx.axis, ctx.dtype = group, axis, x.dtype
        return _gathered(x, group, axis, dtype)

    @staticmethod
    def backward(ctx, g):
        g = ctx.group.reduce_scatter_sum(g.float(), ctx.axis, "grad")
        return g.to(ctx.dtype), None, None, None


def _gathered(x: torch.Tensor, group: Group, axis: int,
              dtype) -> torch.Tensor:
    """The ranks' ``x`` in ``dtype`` joined along ``axis`` in rank
    order (kind ``"fsdp"``)."""
    parts = group.all_gather(x.to(dtype), "fsdp")        # (world, *shape)
    shape = list(x.shape)
    shape[axis] *= group.world
    return parts.movedim(0, axis).reshape(shape)


def gather_shards(x: torch.Tensor, group: Group, axis: int,
                  dtype) -> torch.Tensor:
    """A data-cut leaf read whole: the rank's f32 cut ``x`` cast to the
    compute ``dtype`` and all-gathered along ``axis`` over ``group`` (kind
    ``"fsdp"``); under autograd the gradient of ``x`` is the whole leaf's
    gradient upcast to f32 and reduce-scattered (kind ``"grad"``): the
    data group's f32 sum, each rank its own cut of it (at 2 ranks the
    same two-term sum as an all-reduce, bit for bit)."""
    if not _tracked(x):
        return _gathered(x, group, axis, dtype)
    return _GatherShards.apply(x, group, axis, dtype)


class Shard:
    """A leaf a training rank holds cut over its data group: ``x`` the
    rank's f32 cut along ``axis`` (of ``group.world`` equal parts),
    ``dtype`` the compute dtype the step reads it in.  ``self[l]`` is
    layer ``l``'s cut of a stacked leaf (the leading axis indexed, never
    the cut one); ``whole()`` the leaf gathered (``gather_shards``)."""

    __slots__ = ("x", "axis", "group", "dtype")

    def __init__(self, x: torch.Tensor, axis: int, group: Group, dtype):
        self.x, self.axis, self.group, self.dtype = x, axis, group, dtype

    def __getitem__(self, l: int) -> "Shard":
        return Shard(self.x[l], self.axis - 1, self.group, self.dtype)

    def whole(self) -> torch.Tensor:
        return gather_shards(self.x, self.group, self.axis, self.dtype)


def whole(x):
    """``x`` read whole: a ``Shard`` gathered, a tensor as it is."""
    return x.whole() if isinstance(x, Shard) else x
