"""FSDP over a training mesh's data axis, the parts that need no rank
process: the data cut's metadata against the JAX package's
``param_specs`` / ``opt_state_specs``, and simulated meshes of threads
(``_run_mesh``) for the gather and its reduce-scattered gradient, the
global norm, a factored second moment, the cut's gather and a
checkpoint written at 2x2 and read at other meshes.

The mesh runs themselves (qwen3-0.6b's smoke config at 2x1 and 2x2, and
the moe, ssm, hybrid, vlm and encdec families at D 2, against the JAX
package's single-device step and its ``(2, 2)`` mesh; each rank's state
bytes; which gradients are reduce-scattered) ride
``tests/test_torch_tp.py``'s rank spawns.

Tolerances (f32): a gathered-and-scattered gradient and a data-cut
update are bit for bit the whole one's where the sums have two terms; a
factored moment's means over a cut (the ranks' sums summed, then
divided) within 2e-6 of the whole leaf's, the global norm within 1e-6.
"""
import dataclasses
import queue
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.compat import abstract_mesh  # noqa: E402
from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro.parallel import sharding as jshard  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS, get_config, smoke_config  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.parallel import comm, sharding  # noqa: E402

torch.set_num_threads(2)

QWEN = smoke_config(get_config("qwen3-0.6b"))
MESHES = [(2, 2), (4, 2), (16, 16)]


# -- the data cut's metadata against the reference's specs --------------------
def _path(jpath) -> tuple:
    return tuple(e.key if hasattr(e, "key") else e.idx for e in jpath)


def _data_positions(tree, specs) -> dict:
    """{path: the index of "data" in the leaf's spec, or None}."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat = jax.tree.leaves(specs, is_leaf=lambda s: isinstance(
        s, jax.sharding.PartitionSpec))
    assert len(leaves) == len(flat)
    return {_path(p): (tuple(s).index("data") if "data" in tuple(s)
                       else None) for (p, _), s in zip(leaves, flat)}


def _configs(arch: str, size: str):
    if size == "full":
        return J_ARCHS[arch], get_config(arch)
    return j_smoke(J_ARCHS[arch]), smoke_config(get_config(arch))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_data_axis_is_the_reference_data_position(arch, size, mesh):
    """Every leaf's ``sharding.data_axis`` is the position of ``"data"`` in
    the reference's ``param_specs`` on an abstract (data, model) mesh --
    the rule's axis after the leading stack axes, dropped where the
    dimension does not divide -- and for a factored AdamW state's m, vr
    and vc the position in its ``opt_state_specs`` (the reduced axis
    taken off)."""
    jcfg, tcfg = _configs(arch, size)
    amesh = abstract_mesh(mesh, ("data", "model"))
    params = japi.params_struct(jcfg)
    pspecs = jshard.param_specs(params, amesh, jcfg)
    want = _data_positions(params, pspecs)
    assert want == {p: sharding.data_axis(p, tcfg, mesh[0]) for p in want}
    opt = jax.eval_shape(lambda p: jopt.init_state(
        jopt.AdamWConfig(factored=True), p), params)
    ospecs = jshard.opt_state_specs(opt, pspecs)
    want = _data_positions({"m": opt["m"], "v": opt["v"]},
                           {"m": ospecs["m"], "v": ospecs["v"]})
    assert want == {p: sharding.data_axis(("opt",) + p, tcfg, mesh[0])
                    for p in want}


def test_the_drop_rule_and_a_whole_vocabulary_keep_the_reference_cut():
    """The reference drops "data" from a dimension that does not divide
    (an embedding of D 64 at a data axis of 3) and keeps the D dimension
    of a vocabulary the model axis holds whole (internvl2-26b's 92,553
    ids at model 2: ``("model", "data")`` with its model axis dropped)."""
    assert sharding.data_axis(("embed",), QWEN, 3) is None
    assert sharding.data_axis(("embed",), QWEN, 2) == 1
    vlm = get_config("internvl2-26b")
    plan = sharding.train_plan(vlm, 0, 2, 2)
    assert plan.split.vocab == (0, vlm.vocab_size)
    for leaf in ("embed", "lm_head"):
        shape = sharding.rank_shape((leaf,), weights.param_shapes(vlm)[
            leaf][0], vlm, plan.split, plan.dcut)
        assert vlm.vocab_size in shape and vlm.d_model // 2 in shape


def test_seq_parallel_attention_moves_no_data_axis():
    """Under ``seq_parallel_attn`` the reference's attention rule
    (``("data", None)``, ``(None, "data")``) keeps ``_COL`` / ``_ROW``'s
    data positions, so ``data_axis`` is the same with it."""
    jcfg = dataclasses.replace(J_ARCHS["starcoder2-7b"],
                               seq_parallel_attn=True)
    tcfg = get_config("starcoder2-7b")
    amesh = abstract_mesh((16, 16), ("data", "model"))
    params = japi.params_struct(jcfg)
    want = _data_positions(params, jshard.param_specs(params, amesh, jcfg))
    assert want == {p: sharding.data_axis(p, tcfg, 16) for p in want}


def test_rwkv_decay_lora_cut_nests_in_the_channel_cut():
    """RWKV6's ``wB`` (LORA, D): the reference cuts D over data and not
    over model; the port's model axis cuts its channels, and the data cut
    is the data index's 1/D of the rank's channels -- the one leaf where
    the two cuts take one axis.  A leaf's data cut never meets its model
    cut anywhere else."""
    cfg = smoke_config(get_config("rwkv6-7b"))
    shapes = weights.param_shapes(cfg)
    for r in range(4):
        plan = sharding.train_plan(cfg, r, 2, 2)
        for path, (shape, _) in tree_mod.items(shapes):
            ax = sharding.data_axis(path, cfg, 2)
            cut = sharding.leaf_cut(path, cfg, plan.split)
            if ax is None or cut is None:
                continue
            same = cut[0] % len(shape) == ax
            assert same == (path[-1] == "wB"), path
        path = ("decoder", 0, "slot0", "wB")
        lo, hi = plan.split.chan
        per = (hi - lo) // 2
        x = torch.arange(np.prod(shapes["decoder"][0]["slot0"]["wB"][0]),
                         dtype=torch.float32).reshape(
            shapes["decoder"][0]["slot0"]["wB"][0])
        got = sharding.shard_leaf(path, x, cfg, plan.split, plan.dcut)
        a = lo + plan.d * per
        assert torch.equal(got, x[..., a:a + per])


# -- simulated meshes ---------------------------------------------------------
class ThreadGroup:
    """Rank ``rank`` of ``world`` threads: ``all_gather``,
    ``all_reduce_sum`` and ``reduce_scatter_sum`` (in rank order) through
    a shared barrier, ``send`` / ``recv`` through a queue a pair of
    ranks, bytes counted as ``comm.Group`` counts them."""

    def __init__(self, shared: dict, rank: int):
        self.shared, self.rank = shared, rank
        self.world = shared["world"]
        self.bytes = {}

    @classmethod
    def make(cls, world: int) -> list:
        shared = {"world": world, "slots": [None] * world,
                  "barrier": threading.Barrier(world),
                  "mail": {(a, b): queue.Queue() for a in range(world)
                           for b in range(world)}}
        return [cls(shared, r) for r in range(world)]

    def _count(self, kind, n):
        self.bytes[kind] = self.bytes.get(kind, 0) + n

    def _stack(self, x):
        s = self.shared
        s["slots"][self.rank] = x.detach().clone()
        s["barrier"].wait()
        out = torch.stack(list(s["slots"]))
        s["barrier"].wait()
        return out

    def all_gather(self, x, kind):
        out = self._stack(x)
        self._count(kind, out.numel() * out.element_size())
        return out

    def all_reduce_sum(self, x, kind):
        parts = self._stack(x)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        self._count(kind, x.numel() * x.element_size())
        return x.copy_(total)

    def agree(self, value, what):
        got = self._stack(torch.tensor([value], dtype=torch.int64))
        if len(set(got.flatten().tolist())) > 1:
            raise RuntimeError(f"ranks diverged at {what}")

    def send(self, x, dst, kind):
        self.shared["mail"][self.rank, dst].put(x.detach().clone())
        self._count(kind, x.numel() * x.element_size())

    def recv(self, x, src):
        return x.copy_(self.shared["mail"][src, self.rank].get(timeout=60))

    def reduce_scatter_sum(self, x, axis, kind):
        parts = self._stack(x)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        self._count(kind, x.numel() * x.element_size())
        return total.chunk(self.world, dim=axis)[self.rank].contiguous()


def _run_mesh(D: int, M: int, fn) -> list:
    """``fn(data_group, model_group, rank)`` in ``D x M`` threads, one a
    rank (rank ``r`` at data index ``r // M``, model index ``r % M``; a
    group of one is None); their results in rank order."""
    dgroups = [ThreadGroup.make(D) for _ in range(M)]
    mgroups = [ThreadGroup.make(M) for _ in range(D)]
    barriers = [g[0].shared["barrier"] for g in dgroups + mgroups]
    out, errs = [None] * (D * M), []

    def body(r):
        try:
            out[r] = fn(dgroups[r % M][r // M] if D > 1 else None,
                        mgroups[r // M][r % M] if M > 1 else None, r)
        except Exception as e:          # noqa: BLE001 -- re-raised below
            errs.append(e)
            for b in barriers:
                b.abort()

    threads = [threading.Thread(target=body, args=(r,))
               for r in range(D * M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errs:
        raise errs[0]
    return out


def _mesh(cfg, D, M, dg, mg, r) -> steps_mod.TrainMesh:
    plan = sharding.train_plan(cfg, r, D, M, group=mg, data_group=dg)
    local = cfg if plan.split is None else sharding.local_config(
        cfg, plan.split)
    return steps_mod.TrainMesh(plan, dg, mg, cfg, local, torch.device("cpu"))


def test_gather_shards_carries_its_derivative_bit_for_bit():
    """``comm.gather_shards`` of two ranks' f32 cuts: forward the leaf in
    the compute dtype, joined along the cut axis in rank order (kind
    ``"fsdp"``); backward each rank's cut of the summed gradient upcast
    to f32 (kind ``"grad"``, the reduce-scatter counting its input), bit
    for bit the two-term sum an all-reduce gives."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((6, 8), generator=gen)
    gs = [torch.randn((6, 8), generator=gen).to(torch.bfloat16)
          for _ in range(2)]

    def rank(dg, _, r):
        x = w[:, 4 * r:4 * r + 4].clone().requires_grad_(True)
        y = comm.gather_shards(x, dg, 1, torch.bfloat16)
        assert y.dtype == torch.bfloat16 and y.shape == (6, 8)
        assert torch.equal(y, w.to(torch.bfloat16))
        y.backward(gs[r])
        return x.grad, dict(dg.bytes)

    res = _run_mesh(2, 1, rank)
    total = gs[0].float() + gs[1].float()
    for r, (g, nbytes) in enumerate(res):
        assert g.dtype == torch.float32
        assert torch.equal(g, total[:, 4 * r:4 * r + 4])
        assert nbytes == {"fsdp": 6 * 8 * 2, "grad": 6 * 8 * 4}


def _whole_grads(cfg, host, batch):
    return steps_mod.loss_and_grads(
        tree_mod.map_tree(lambda _, t: t.clone(), host), cfg, batch)


def _batch(cfg, rows=4, seq=8, seed=0):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq + 1))
                            .astype(np.int32))
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("D,M", [(2, 1), (2, 2)])
def test_mesh_grads_and_update_match_the_whole_step(D, M):
    """qwen3's smoke config on a simulated D x M mesh: the loss and every
    gradient leaf gathered back to the whole layout equal the
    single-device step's within f32 reordering (1e-6 of a leaf's largest
    |value|), and so do AdamW's moments after one step (2e-6); the
    masters after it within a tenth of the learning rate (the first
    step's ``m / sqrt(v)`` of a gradient near zero moves a master by up to
    ``lr``, so a reordering at 1e-7 of its gradient moves it by a part of
    ``lr``).  The rank's masters, moments and gradients are its cut, never
    the whole data-cut leaf."""
    cfg = dataclasses.replace(QWEN, dtype="float32")
    host = weights.seeded_params(cfg, 1, "cpu")
    batch = _batch(cfg)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    wloss, wgrads = _whole_grads(cfg, host, batch)
    wparams = tree_mod.map_tree(lambda _, t: t.clone(), host)
    wstate = {"params": wparams, "opt": topt.init_state(opt, wparams)}
    steps_mod.make_train_step(cfg, opt)(wstate, batch)
    rows = batch["tokens"].shape[0] // D

    def rank(dg, mg, r):
        mesh = _mesh(cfg, D, M, dg, mg, r)
        d = mesh.plan.d
        mine = tree_mod.map_tree(lambda _, t: t.clone(), mesh.shard(host))
        for path, t in tree_mod.items(mine):
            if mesh.data_axis(path) is not None:
                assert t.shape[mesh.data_axis(path)] * D == \
                    sharding.rank_shape(path, tree_mod.get(
                        host, path).shape, cfg, mesh.split)[
                        mesh.data_axis(path)]
        rb = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
        loss, grads = steps_mod.loss_and_grads(
            tree_mod.map_tree(lambda _, t: t.clone(), mine), mesh.cfg, rb,
            mesh)
        state = {"params": mine, "opt": topt.init_state(opt, mine)}
        steps_mod.make_train_step(mesh.cfg, opt, mesh)(state, rb)
        return (float(loss), mesh.gather(grads), mesh.gather(state))

    for loss, grads, state in _run_mesh(D, M, rank):
        assert abs(loss - float(wloss)) <= 1e-6 * abs(float(wloss))
        for (path, a), (_, b) in zip(tree_mod.items(wgrads),
                                     tree_mod.items(grads)):
            assert torch.allclose(a, b, rtol=0,
                                  atol=1e-6 * float(a.abs().max())), path
        for (path, a), (_, b) in zip(tree_mod.items(wstate),
                                     tree_mod.items(state)):
            a, b = a.float(), b.float()
            tol = 0.1 * opt.lr if path[0] == "params" else 2e-6 * max(
                float(a.abs().max()), 1e-30)
            assert torch.allclose(a, b, rtol=0, atol=tol), path


def test_global_norm_sums_each_cut_over_its_groups():
    """``optimizer.global_norm`` at 2x2 over leaves cut by the model axis,
    the data axis, both and neither (a kv copy: a split leaf both model
    ranks hold whole, skipped on model rank 1) is the whole tree's norm,
    the same bits on every rank; the data group sums two f32 (kind
    ``"norm"``), the model group one."""
    gen = torch.Generator().manual_seed(2)
    whole = {"both": torch.randn((4, 4), generator=gen),
             "model": torch.randn((4, 6), generator=gen),
             "data": torch.randn((6, 4), generator=gen),
             "none": torch.randn((5,), generator=gen),
             "copy": torch.randn((3, 4), generator=gen)}
    axes = {"both": (0, 1), "model": (1, None), "data": (None, 0),
            "none": (None, None), "copy": (None, 1)}

    def cut(x, ax, i):
        return x if ax is None else x.chunk(2, dim=ax)[i]

    def rank(dg, mg, r):
        d, m = r // 2, r % 2
        tree = {k: cut(cut(v, axes[k][0], m), axes[k][1], d)
                for k, v in whole.items()}
        norm = topt.global_norm(
            tree, model=mg, split_leaf=lambda p: p[0] == "copy"
            or axes[p[0]][0] is not None,
            skip_leaf=lambda p: p[0] == "copy" and m == 1,
            data=dg, data_axis=lambda p: axes[p[0]][1])
        return norm, dict(dg.bytes), dict(mg.bytes)

    want = torch.sqrt(sum(torch.sum(v * v) for v in whole.values()))
    res = _run_mesh(2, 2, rank)
    for norm, db, mb in res:
        assert torch.equal(norm, res[0][0])
        assert abs(float(norm) - float(want)) <= 1e-6 * float(want)
        assert db == {"norm": 8} and mb == {"norm": 4}


def test_factored_moments_over_a_data_cut_are_the_whole_leafs():
    """A factored second moment (Adafactor's row and column means and
    their rank-1 value) on leaves cut over data along their last axis,
    their second-to-last and a leading one: two AdamW steps at D 2 give
    the masters, ``m``, ``vr`` and ``vc`` of the whole leaves (each
    rank's cut), the means' parts summed over the data group (kind
    ``"opt"``)."""
    gen = torch.Generator().manual_seed(4)
    opt = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4,
                           factored=True)
    shapes = {"last": ((2, 6, 8), 2), "rows": ((2, 8, 6), 1),
              "lead": ((4, 6, 8), 0)}
    params = {k: torch.randn(s, generator=gen) for k, (s, _) in
              shapes.items()}
    grads = [{k: torch.randn(s, generator=gen) for k, (s, _) in
              shapes.items()} for _ in range(2)]
    wp = tree_mod.map_tree(lambda _, t: t.clone(), params)
    wstate = topt.init_state(opt, wp)
    for g in grads:
        topt.update(opt, g, wstate, wp)

    def rank(dg, _, r):
        p = {k: t.chunk(2, dim=shapes[k][1])[r].clone()
             for k, t in params.items()}
        state = topt.init_state(opt, p)
        for g in grads:
            gr = {k: t.chunk(2, dim=shapes[k][1])[r].clone()
                  for k, t in g.items()}
            topt.update(opt, gr, state, p, data=dg,
                        data_axis=lambda path: shapes[path[0]][1])
        return p, state, dict(dg.bytes)

    res = _run_mesh(2, 1, rank)
    for k, (shape, ax) in shapes.items():
        got = torch.cat([res[r][0][k] for r in range(2)], dim=ax)
        assert torch.allclose(got, wp[k], rtol=0, atol=2e-6), k
        vr = wstate["v"][k]["vr"]
        vc = wstate["v"][k]["vc"]
        n = len(shape)
        rv = [res[r][1]["v"][k] for r in range(2)]
        got_vr = rv[0]["vr"] if ax == n - 1 else torch.cat(
            [v["vr"] for v in rv], dim=ax)
        got_vc = rv[0]["vc"] if ax == n - 2 else torch.cat(
            [v["vc"] for v in rv], dim=ax if ax < n - 2 else ax - 1)
        assert torch.allclose(got_vr, vr, rtol=2e-6, atol=0), k
        assert torch.allclose(got_vc, vc, rtol=2e-6, atol=0), k
    assert res[0][2]["opt"] > 0


def test_checkpoint_written_at_2x2_reads_at_1x1_1x2_and_2x2(tmp_path):
    """A whole train state cut to a 2x2 mesh's ranks
    (``TrainMesh.shard``: the model slice, then the data index's 1/D) and
    written by ``launch.train.save_state`` (gathered to rank 0's host,
    the other ranks only sending their cuts) is the whole state
    bit for bit: restored at 1x1 it is the whole, at 1x2 and at 2x2
    (``restore(split=, dcut=)``) each rank's cut of it; and a checkpoint
    written at 1x1 restores into the 2x2 cuts the same way."""
    opt = topt.AdamWConfig()
    host = weights.seeded_params(QWEN, 6, "cpu")
    whole = {"params": host, "opt": topt.init_state(opt, host)}
    whole["opt"]["m"] = tree_mod.map_tree(lambda _, t: torch.randn_like(t),
                                          whole["opt"]["m"])
    whole["opt"]["step"].fill_(3)
    struct = steps_mod.train_state_struct(QWEN, opt)

    def rank(dg, mg, r):
        mesh = _mesh(QWEN, 2, 2, dg, mg, r)
        mine = mesh.shard(whole)
        train_mod.save_state(CheckpointManager(tmp_path / "a"), 3, mine,
                             mesh)
        # gathered to rank 0 alone: data index 1 sends its data-cut
        # leaves over the data group and nothing else; rank 0 sends none
        cut = sum(t.numel() * t.element_size()
                  for path, t in tree_mod.items(mine)
                  if mesh.data_axis(path) is not None)
        sent = (dg.bytes.get("ckpt", 0), mg.bytes.get("ckpt", 0))
        if r == 0:
            assert sent == (0, 0), sent
        elif mesh.plan.d == 1:
            assert sent == (cut, 0), (r, sent, cut)
        return mine

    cuts = _run_mesh(2, 2, rank)
    CheckpointManager(tmp_path / "b").save(3, whole)
    for name in ("a", "b"):
        mgr = CheckpointManager(tmp_path / name)
        back = mgr.restore(3, struct)
        for (path, a), (_, b) in zip(tree_mod.items(whole),
                                     tree_mod.items(back)):
            assert torch.equal(a, b), (name, path)
        for D, M in ((1, 2), (2, 2)):
            for r in range(D * M):
                plan = sharding.train_plan(QWEN, r, D, M)
                got = mgr.restore(3, struct, cfg=QWEN, split=plan.split,
                                  dcut=plan.dcut)
                want = weights.shard_params(whole, QWEN, plan.split,
                                            plan.dcut)
                if (D, M) == (2, 2):
                    for a, b in zip(tree_mod.leaves(want),
                                    tree_mod.leaves(cuts[r])):
                        assert torch.equal(a, b)
                for (path, a), (_, b) in zip(tree_mod.items(want),
                                             tree_mod.items(got)):
                    assert torch.equal(a, b), (name, D, M, r, path)
