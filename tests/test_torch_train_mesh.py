"""Training on a (data, model) mesh, the plain parts on the CPU: the
vocabulary-parallel loss over simulated slices against the JAX package's
``xent_loss``, the split's gather, the refusals, the data shards, the
digest, a checkpoint restored into a slice and the pipeline's bubble.

The mesh runs themselves (qwen3-0.6b's smoke config at 1x2, 2x1 and 2x2
against the JAX package's single-device step and its own ``(2, 2)``
mesh) ride ``tests/test_torch_tp.py``'s rank spawns.

A simulated group is threads of one process (``ThreadGroup``): each
thread a rank holding its vocabulary slice, the collectives through a
barrier, summed in rank order -- the numbers a gloo group gives.

Tolerances (f32): the loss within 1e-6 of JAX's, the logits' gradient
within 1e-6 of its largest |value| (the merge of the slices' stats sums
``exp`` in another order than one pass over the row).
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, smoke_config as j_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402
from repro_torch.parallel import comm, sharding  # noqa: E402
from repro_torch.parallel.pipeline import bubble_fraction  # noqa: E402
from repro_torch.runtime.fault_tolerance import elastic_reshard  # noqa: E402

torch.set_num_threads(2)

LOSS_TOL = 1e-6
GRAD_TOL = 1e-6
QWEN = smoke_config(get_config("qwen3-0.6b"))


class ThreadGroup:
    """Rank ``rank`` of ``world`` threads: ``all_gather`` and
    ``all_reduce_sum`` (in rank order) through a shared barrier, bytes
    counted as ``comm.Group`` counts them."""

    def __init__(self, shared: dict, rank: int):
        self.shared, self.rank = shared, rank
        self.world = shared["world"]
        self.bytes = {}

    @classmethod
    def make(cls, world: int) -> list:
        shared = {"world": world, "slots": [None] * world,
                  "barrier": threading.Barrier(world)}
        return [cls(shared, r) for r in range(world)]

    def all_gather(self, x, kind):
        s = self.shared
        s["slots"][self.rank] = x.clone()
        s["barrier"].wait()
        out = torch.stack(list(s["slots"]))
        s["barrier"].wait()
        self.bytes[kind] = self.bytes.get(kind, 0) + out.numel() * 4
        return out

    def all_reduce_sum(self, x, kind):
        parts = self.all_gather(x, kind)
        total = parts[0].clone()
        for p in parts[1:]:
            total += p
        return x.copy_(total)


def _run_ranks(world: int, fn) -> list:
    """``fn(group)`` in ``world`` threads, one a rank; their results in
    rank order (an exception in any thread re-raised)."""
    groups = ThreadGroup.make(world)
    out, errs = [None] * world, []

    def body(g):
        try:
            out[g.rank] = fn(g)
        except Exception as e:          # noqa: BLE001 -- re-raised below
            errs.append(e)
            g.shared["barrier"].abort()

    threads = [threading.Thread(target=body, args=(g,)) for g in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errs:
        raise errs[0]
    return out


def _xent_inputs(rows=12, v=256, world=4, seed=3):
    """Logits (rows, v) f32 with a wide spread, and labels that sit on
    every slice's first and last id (for 2 and 4 slices), in the last
    slice, and anywhere."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, v)) * 4).astype(np.float32)
    per = v // world
    edges = [0, per - 1, per, 2 * per - 1, 2 * per, v - per, v - 1]
    labels = np.array(edges + list(rng.integers(0, v, rows - len(edges))),
                      np.int32)
    mask = (rng.random(rows) < 0.7).astype(np.float32)
    return x, labels, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_vocab_parallel_loss_matches_jax_xent_loss(world, masked):
    """``api.xent_loss(split=...)`` over ``world`` simulated vocabulary
    slices -- the stats of each slice all-gathered and merged, the label
    logit picked by the rank that holds it (labels on slice edges and in
    the last slice) -- gives JAX's ``xent_loss`` on every rank, and the
    slices' gradients put side by side give JAX's gradient of the whole
    logits, with and without a mask.  One slice (world 1) is the whole
    vocabulary, through ``ops.softmax_xent``."""
    x, labels, mask = _xent_inputs()
    v = x.shape[1]
    jm = jnp.asarray(mask) if masked else None
    want, wgrad = jax.value_and_grad(
        lambda lg: japi.xent_loss(lg, jnp.asarray(labels), jm))(
            jnp.asarray(x))

    def rank(g):
        lo, hi = g.rank * v // world, (g.rank + 1) * v // world
        split = sharding.Split(g.rank, world, True, (0, 1), (0, 1), (0, 1),
                               (lo, hi), group=g)
        xl = torch.from_numpy(x[:, lo:hi].copy()).requires_grad_(True)
        loss = tapi.xent_loss(xl, torch.from_numpy(labels).long(),
                              torch.from_numpy(mask) if masked else None,
                              split=split)
        loss.backward()
        return float(loss.detach()), xl.grad.numpy(), g.bytes

    res = _run_ranks(world, rank)
    for loss, _, _ in res:
        assert abs(loss - float(want)) <= LOSS_TOL * max(1, abs(float(want)))
    grad = np.concatenate([g for _, g, _ in res], axis=1)
    wg = np.asarray(wgrad)
    assert np.abs(grad - wg).max() <= GRAD_TOL * np.abs(wg).max()
    # the loss's traffic: (m, l) pairs all-gathered and one label
    # all-reduce, rows x (2 x world + world) x 4 bytes, never rows x V;
    # one slice is the whole vocabulary, through the cross-entropy path
    want_bytes = x.shape[0] * (2 * world + world) * 4
    assert res[0][2] == ({"loss": want_bytes} if world > 1 else {})


def test_merge_of_slice_stats_is_bitwise_on_repeat():
    """``api.merge_stats`` of the same (ranks, rows, 2) stats gives the
    same bits every time, and equals the row's logsumexp within one
    f32 rounding per slice."""
    x, _, _ = _xent_inputs(rows=64)
    t = torch.from_numpy(x)
    stats = torch.stack([torch.stack([s.amax(1), torch.exp(
        s - s.amax(1, keepdim=True)).sum(1)], 1) for s in t.chunk(4, 1)])
    a, b = tapi.merge_stats(stats), tapi.merge_stats(stats.clone())
    assert torch.equal(a, b)
    want = torch.logsumexp(t.double(), 1).float()
    assert torch.allclose(a, want, rtol=4 * 2.0 ** -23, atol=0)


def test_split_leaves_gather_back_to_the_whole_tree():
    """``weights.shard_params`` of a whole train state (params and AdamW's
    m / v) at a model axis of 2, then ``sharding.gather_tree`` over a
    simulated group, is the whole state bit for bit; each split leaf's
    axis is the one ``shard_leaf`` cut."""
    host = weights.seeded_params(QWEN, 5, "cpu")
    opt = topt.AdamWConfig()
    state = {"params": host, "opt": topt.init_state(opt, host)}
    state["opt"]["m"] = tree_mod.map_tree(
        lambda _, t: torch.randn_like(t), state["opt"]["m"])

    def rank(g):
        split = sharding.plan(QWEN, g.rank, 2, group=g)
        mine = weights.shard_params(state, QWEN, split)
        return sharding.gather_tree(mine, QWEN, split)

    for whole in _run_ranks(2, rank):
        for (path, a), (_, b) in zip(tree_mod.items(state),
                                     tree_mod.items(whole)):
            assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ["internvl2-26b",
                                  "seamless-m4t-large-v2"])
def test_train_plan_places_the_vlm_and_encdec_families(arch):
    """The vlm and encdec families train under a model axis: at 1x2, 2x1,
    2x2 and 1x4 rank ``r`` of the smoke config sits at data index ``r //
    M`` and model index ``r % M`` with that model rank's q heads, MLP
    columns and vocabulary slice (at 4 a copy of one of the 2 kv heads);
    with vocab_size 255 (internvl2's case: divides by neither 2 nor 4)
    or 258 (seamless's: by 2, not 4) a model axis that does not divide it
    keeps ``Split.vocab == (0, V)`` on every rank, the embedding and an
    untied head whole (``leaf_cut`` None), while serving's ``plan``
    still refuses it; at full width internvl2-26b's 92,553 ids stay whole
    at 2 and 4, seamless's 256,206 split at 2 and stay whole at 4."""
    cfg = smoke_config(get_config(arch))
    odd = dataclasses.replace(
        cfg, vocab_size=255 if arch == "internvl2-26b" else 258)
    full = get_config(arch)
    for D, M in ((1, 2), (2, 1), (2, 2), (1, 4)):
        for r in range(D * M):
            p = sharding.train_plan(cfg, r, D, M)
            assert (p.d, p.m) == (r // M, r % M)
            if M == 1:
                assert p.split is None
                continue
            m, per = r % M, 4 // M
            assert p.split.q == (per * m, per * (m + 1))
            assert p.split.ff == (128 // M * m, 128 // M * (m + 1))
            assert p.split.vocab == (256 // M * m, 256 // M * (m + 1))
            assert p.split.kv == ((m // 2, m // 2 + 1) if M == 4
                                  else (m, m + 1))
            for c in (odd, full):
                sp = sharding.train_plan(c, r, D, M).split
                v = c.vocab_size
                if v % M:
                    assert sp.vocab == (0, v)
                    for key in ("embed", "lm_head"):
                        assert sharding.leaf_cut((key,), c, sp) is None
                    with pytest.raises(ValueError, match="vocab_size"):
                        sharding.plan(c, m, M)
                else:
                    assert sp.vocab == (v // M * m, v // M * (m + 1))
    assert sharding.kv_copies(odd, 4) == [[0, 1], [2, 3]]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_train_plan_places_the_moe_ssm_and_hybrid_families(arch):
    """The ssm, hybrid and moe families train under a model axis: at 1x2,
    2x1 and 2x2 rank ``r`` sits at data index ``r // M`` and model index
    ``r % M`` with that model rank's heads (an RWKV6 layer's, or the
    RG-LRU's gate blocks with them), channels, experts and vocabulary;
    recurrentgemma's one kv head is copied to both model ranks."""
    cfg = smoke_config(get_config(arch))
    for D, M in ((1, 2), (2, 1), (2, 2)):
        for r in range(D * M):
            p = sharding.train_plan(cfg, r, D, M)
            assert (p.d, p.m) == (r // M, r % M)
            if M == 1:
                assert p.split is None
                continue
            m = r % M
            assert p.split.vocab == (128 * m, 128 * (m + 1))
            assert p.split.q == (2 * m, 2 * m + 2)
            if cfg.moe is not None:
                assert p.split.experts == (2 * m, 2 * m + 2)
            if cfg.family in ("ssm", "hybrid"):
                assert p.split.chan == (32 * m, 32 * m + 32)
    copies = sharding.kv_copies(cfg, 2)
    assert copies == ([[0, 1]] if arch == "recurrentgemma-2b" else None)


def test_train_plan_refuses_moe_over_data_and_places_ranks():
    """The moe family under D > 1 is placed (its router loss reads the
    global means over the data group), but only with the gshard
    executor, whose groups lie within a row; a dense rank ``r`` of a 2x2
    mesh sits at data index ``r // 2`` and model index ``r % 2`` with
    that model rank's heads and vocabulary; at 1x4 qwen3's 2 kv heads
    are copied, each to the 2 ranks whose q heads read it; a rank
    outside the mesh raises."""
    moe = smoke_config(get_config("phi3.5-moe-42b-a6.6b"))
    for r in range(2):
        p = sharding.train_plan(moe, r, 2, 1)
        assert (p.d, p.m, p.split) == (r, 0, None)
    with pytest.raises(ValueError, match="only gshard's groups"):
        sharding.train_plan(dataclasses.replace(moe, moe_impl="scatter"),
                            0, 2, 1)
    for r in range(4):
        p = sharding.train_plan(QWEN, r, 2, 2)
        assert (p.d, p.m) == (r // 2, r % 2)
        assert p.split.vocab == (128 * (r % 2), 128 * (r % 2 + 1))
        assert p.split.q == (2 * (r % 2), 2 * (r % 2 + 1))
    kv = [sharding.train_plan(QWEN, r, 1, 4).split.kv for r in range(4)]
    assert kv == [(0, 1), (0, 1), (1, 2), (1, 2)]
    assert sharding.kv_copies(QWEN, 4) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="outside a mesh"):
        sharding.train_plan(QWEN, 4, 2, 2)


def test_pipeline_cuts_the_global_batch_into_data_shards():
    """Data shard ``d`` of ``D`` holds rows ``[d B / D, (d + 1) B / D)``
    of the global batch, bit for bit; a batch that does not divide by
    ``D`` raises."""
    shape = ShapeSpec("t", 16, 4, "train")
    dc = DataConfig(vocab_size=QWEN.vocab_size)
    whole = TokenPipeline(dc, QWEN, shape).batch(3)
    for d in range(2):
        part = TokenPipeline(dc, QWEN, shape, data=2, d=d).batch(3)
        for k in ("tokens", "labels"):
            assert torch.equal(part[k], whole[k][2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="does not cut into 3 data"):
        TokenPipeline(dc, QWEN, shape, data=3, d=0)


def test_a_data_shard_draws_its_stub_embeddings_afresh():
    """The vlm and encdec frontends' stub embeddings of a data shard are
    drawn from its own first row (``data.pipeline._stub_embeds``, a copy
    of the reference's ``TokenPipeline._stub_embeds``,
    ``repro/data/pipeline.py:121-135``), not cut from the global batch's:
    shard 1 of 2 holds the global batch's token rows bit for bit, but
    other image / frame embeddings than the same rows at data 1 -- so the
    mesh runs held to a single-device step cut the global batch's rows
    by hand."""
    shape = ShapeSpec("t", 16, 4, "train")
    for arch, key in (("internvl2-26b", "image_embeds"),
                      ("seamless-m4t-large-v2", "src_embeds")):
        cfg = smoke_config(get_config(arch))
        dc = DataConfig(vocab_size=cfg.vocab_size)
        whole = TokenPipeline(dc, cfg, shape).batch(2)
        part = TokenPipeline(dc, cfg, shape, data=2, d=1).batch(2)
        assert torch.equal(part["tokens"], whole["tokens"][2:])
        assert part[key].shape == whole[key][2:].shape
        assert not torch.equal(part[key], whole[key][2:])
        first = TokenPipeline(dc, cfg, shape, data=2, d=0).batch(2)
        assert torch.equal(first[key], whole[key][:2])


def test_factored_second_moment_refuses_a_split_model_axis():
    """``factored=True`` takes row and column means along axes a split
    cuts: refused under a model axis (``make_train_step``, ``update``),
    taken at model 1."""
    cfg = topt.AdamWConfig(factored=True)
    with pytest.raises(ValueError, match="factored=True under a split"):
        topt.check_split(cfg, True)
    topt.check_split(cfg, False)
    mesh = steps_mod.TrainMesh(sharding.TrainPlan(1, 2, 0, 0, None), None,
                               object(), QWEN, QWEN, torch.device("cpu"))
    with pytest.raises(ValueError, match="factored=True under a split"):
        steps_mod.make_train_step(QWEN, cfg, mesh)


def test_mesh_refuses_a_world_that_is_not_d_times_m():
    """``comm.mesh_groups`` / ``steps.make_mesh`` refuse a world other
    than D x M, and ``parse_mesh`` a malformed ``--mesh``."""
    class One:
        rank, world = 0, 3

    with pytest.raises(ValueError, match="needs 4 ranks; the group has 3"):
        comm.mesh_groups(One(), 2, 2)
    with pytest.raises(ValueError, match="needs 4 ranks; the world has 3"):
        steps_mod.make_mesh(QWEN, One(), 2, 2)
    assert steps_mod.parse_mesh("2x2") == (2, 2)
    assert steps_mod.parse_mesh(None) == (1, 1)
    with pytest.raises(ValueError, match="expected DxM"):
        steps_mod.parse_mesh("4")


def test_digest_sees_one_flipped_bit():
    """``steps.digest``: equal trees give equal digests; one flipped bit
    of one f32 leaf changes it."""
    a = weights.seeded_params(QWEN, 2, "cpu")
    b = tree_mod.map_tree(lambda _, t: t.clone(), a)
    assert steps_mod.digest(a) == steps_mod.digest(b)
    w = b["final_norm"].view(torch.int32)
    w[3] ^= 1
    assert steps_mod.digest(a) != steps_mod.digest(b)


def test_restore_and_reshard_put_a_whole_state_into_a_rank_slice(tmp_path):
    """A whole train state written by ``CheckpointManager`` restores
    straight into rank ``r``'s slice (``restore(split=)``, read through
    a memory map) and ``elastic_reshard`` cuts the same slice from the
    whole tree: both equal ``shard_params`` of the whole, bit for bit."""
    opt = topt.AdamWConfig()
    host = weights.seeded_params(QWEN, 4, "cpu")
    state = {"params": host, "opt": topt.init_state(opt, host)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, state)
    struct = steps_mod.train_state_struct(QWEN, opt)
    for r in range(2):
        split = sharding.plan(QWEN, r, 2)
        want = weights.shard_params(state, QWEN, split)
        got = mgr.restore(7, struct, cfg=QWEN, split=split)
        moved = elastic_reshard(state, "cpu", cfg=QWEN, split=split)
        for (path, a), (_, b), (_, c) in zip(tree_mod.items(want),
                                             tree_mod.items(got),
                                             tree_mod.items(moved)):
            assert torch.equal(a, b) and torch.equal(a, c), path


def test_bubble_fraction_is_the_reference_formula():
    """(P - 1) / (M + P - 1), as ``repro.parallel.pipeline``."""
    from repro.parallel.pipeline import bubble_fraction as jbubble

    assert bubble_fraction(4, 4) == 3 / 7
    for p, m in ((1, 8), (2, 3), (8, 32)):
        assert bubble_fraction(p, m) == jbubble(p, m)


def test_split_rank_gradients_match_jax_once_qk_norm_parts_are_summed():
    """``steps.rank_grads`` at a model axis of 2 on simulated ranks, on
    bridged smoke weights: every rank's loss is JAX's ``train_loss``; the
    tied embedding's slices (the lookup's gradient and the head's) put
    together give JAX's gradient; each rank's qk-norm scale gradient is
    a part (its own heads' share) that alone misses JAX's by far, and the
    ranks' parts summed -- what ``steps.complete_grads`` does over the
    model group -- give it."""
    jcfg = j_smoke(J_ARCHS["qwen3-0.6b"])
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, jcfg, jb)))(jparams)
    host = weights.from_numpy_params(np_tree, QWEN, "cpu")
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}

    def rank(g):
        split = sharding.plan(QWEN, g.rank, 2, group=g)
        local = sharding.local_config(QWEN, split)
        mine = weights.shard_params(host, QWEN, split)
        loss, grads = steps_mod.rank_grads(mine, local, batch)
        attn = grads["decoder"][0]["slot0"]["attn"]
        return (float(loss), grads["embed"].numpy(),
                {k: attn[k].numpy() for k in ("q_norm", "k_norm")})

    res = _run_ranks(2, rank)
    for loss, _, _ in res:
        assert abs(loss - float(want)) <= 1e-5
    emb = np.concatenate([e for _, e, _ in res], axis=0)
    we = np.asarray(wgrads["embed"])
    assert np.abs(emb - we).max() <= 5e-5 * np.abs(we).max()
    jattn = wgrads["decoder"][0]["slot0"]["attn"]
    for k in ("q_norm", "k_norm"):
        w = np.asarray(jattn[k])
        scale = np.abs(w).max()
        assert np.abs(res[0][2][k] - w).max() > 0.05 * scale, k
        summed = res[0][2][k] + res[1][2][k]
        assert np.abs(summed - w).max() <= 5e-5 * scale, k


def test_sum_gather_and_share_carry_their_derivatives():
    """The collectives for sums a rank reads only part of, on 2 simulated
    ranks: ``sum_to_group``'s backward sums the ranks' gradients (each
    rank reads its own half of the sum), ``gather_from_group``'s hands a
    rank its own slice, ``share_grad``'s divides by the group's size --
    each against the same function on one process; without grad each is
    the in-place serving collective (or nothing), its bytes counted."""
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((2, 3, 4)).astype(np.float32)
    w = rng.standard_normal((3, 4)).astype(np.float32)

    whole = torch.from_numpy(xs.copy()).requires_grad_(True)
    total = whole.sum(0)
    # rank r reads columns [2r, 2r + 2) of the sum, then the products are
    # gathered and every rank weighs the whole by w; a term both ranks
    # compute whole counts once
    ref = (torch.cat([total[:, :2] * 2, total[:, 2:] * 3], 1)
           * torch.from_numpy(w)).sum() + whole.sum() ** 2
    ref.backward()

    def rank(g):
        x = torch.from_numpy(xs[g.rank].copy()).requires_grad_(True)
        s = comm.sum_to_group(x, g, "trunk")
        part = s[:, 2 * g.rank:2 * g.rank + 2] * (2 + g.rank)
        y = comm.gather_from_group(part, g, "trunk")      # (2, 3, 2)
        y = y.permute(1, 0, 2).reshape(3, 4)
        sq = comm.share_grad(comm.sum_to_group(x.sum().reshape(1), g,
                                               "aux")[0] ** 2, g)
        ((y * torch.from_numpy(w)).sum() + sq).backward()
        with torch.no_grad():
            z = torch.ones(2)
            same = comm.sum_to_group(z, g, "serve") is z
            got = comm.gather_from_group(z, g, "serve").shape
            kept = comm.share_grad(z, g) is z
        return x.grad.numpy(), (same, tuple(got), kept), g.bytes

    for r, (grad, (same, got, kept), nbytes) in enumerate(_run_ranks(2,
                                                                     rank)):
        np.testing.assert_allclose(grad, whole.grad.numpy()[r], rtol=1e-6,
                                   atol=1e-6)
        assert same and kept and got == (2, 2)
        # the sum and the gather of 2 f32 over 2 ranks (a ThreadGroup
        # counts a sum as the gather it runs)
        assert nbytes["serve"] == 2 * (2 * 2 * 4)


def test_router_loss_shares_over_a_data_group_are_the_global_one():
    """``layers.moe_aux_loss`` over 2 simulated data ranks, each with its
    block of the tokens: the shares sum to the router loss of all the
    tokens at once, and each rank's probabilities get the whole batch's
    gradient; the ranks' own losses (their own means) would not sum to
    it.  The counts' traffic is E + 1 f32 a rank."""
    from repro_torch.models.layers import moe_aux_loss

    rng = np.random.default_rng(4)
    logits = rng.standard_normal((12, 4)).astype(np.float32)
    idx = np.argsort(-logits, axis=1)[:, :2].copy()
    idx[:5] = [0, 1]                     # rank 0's tokens lean to expert 0
    whole = torch.softmax(torch.from_numpy(logits), -1).requires_grad_(True)
    want = moe_aux_loss(whole, torch.from_numpy(idx), 4)
    want.backward()

    def rank(g):
        lo = 6 * g.rank
        p = torch.softmax(torch.from_numpy(logits[lo:lo + 6]), -1)
        p.requires_grad_(True)
        share = moe_aux_loss(p, torch.from_numpy(idx[lo:lo + 6]), 4, g)
        share.backward()
        own = moe_aux_loss(p.detach(), torch.from_numpy(idx[lo:lo + 6]), 4)
        return share.item(), own.item(), p.grad.numpy(), g.bytes

    res = _run_ranks(2, rank)
    assert abs(sum(r[0] for r in res) - want.item()) <= 1e-6
    assert abs(sum(r[1] for r in res) / 2 - want.item()) > 1e-3
    grad = np.concatenate([r[2] for r in res])
    np.testing.assert_allclose(grad, whole.grad.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert res[0][3] == {"aux": 2 * (4 + 1) * 4}


@pytest.mark.parametrize("arch,world", [("phi3.5-moe-42b-a6.6b", 2),
                                        ("rwkv6-7b", 2),
                                        ("recurrentgemma-2b", 2),
                                        ("qwen3-0.6b", 4),
                                        ("seamless-m4t-large-v2", 4)])
def test_family_train_state_gathers_back_to_the_whole(arch, world):
    """``weights.shard_params`` of a whole train state of the moe, ssm,
    hybrid and encdec families (qwen3 and seamless with their kv heads
    copied at 4: a copied cross-attention's wk / wv taken once too), then
    ``sharding.gather_tree`` over a simulated model group, is the whole
    state bit for bit: ``split_axis`` reads the same path rule as
    ``shard_leaf`` (``leaf_cut``) -- a moe expert stack joins along E,
    ``rec/w_out`` by rows, ``w_a`` / ``w_i`` by gate block -- and a
    copied kv head is taken once."""
    cfg = smoke_config(get_config(arch))
    host = weights.seeded_params(cfg, 5, "cpu")
    opt = topt.AdamWConfig()
    state = {"params": host, "opt": topt.init_state(opt, host)}
    state["opt"]["v"] = tree_mod.map_tree(
        lambda _, t: torch.rand_like(t), state["opt"]["v"])

    def rank(g):
        split = sharding.plan(cfg, g.rank, world, group=g)
        mine = weights.shard_params(state, cfg, split)
        for path, x in tree_mod.items(mine):
            cut = sharding.leaf_cut(path, cfg, split)
            assert sharding.split_axis(path, cfg, split) == (
                None if cut is None else cut[0]), path
        return sharding.gather_tree(mine, cfg, split)

    for whole in _run_ranks(world, rank):
        for (path, a), (_, b) in zip(tree_mod.items(state),
                                     tree_mod.items(whole)):
            assert torch.equal(a, b), path
    if cfg.moe is not None:
        split = sharding.plan(cfg, 1, world)
        path = ("params", "decoder", 0, "slot0", "moe", "w_gate")
        assert sharding.leaf_cut(path, cfg, split) == (1, 2, 4)
