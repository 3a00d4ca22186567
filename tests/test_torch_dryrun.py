"""The port's dry-run (``repro_torch.launch.dryrun``): a walk of one
rank's step on the ``meta`` device, counted by ``launch.hlo_stats``.

Every equality here is exact: ``model_flops`` against the JAX package's
``repro.launch.segment_cost.model_flops``; a walk's FLOPs against
``FlopCounterMode`` over the same step on real CPU tensors; the walk's
param and AdamW bytes against ``sharding.rank_param_count``; a cell's
segments times their counts against the whole-step walk, in FLOPs and
collective bytes (HBM bytes within 1e-5).  (``repro.launch.dryrun`` itself is never imported:
it sets ``XLA_FLAGS`` for 512 host devices at import.)  The collective
bytes against the gloo ranks' real steps ride ``test_torch_tp.py``'s
rank spawns (``test_dryrun_walk_counts_the_mesh_step_bytes``).
"""
import dataclasses
import json
import types

import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import ARCHS as J_ARCHS, SHAPES as J_SHAPES  # noqa: E402
from repro.launch import segment_cost as jseg  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import meta, ops, ref  # noqa: E402
from repro_torch.launch import dryrun, hlo_stats, roofline  # noqa: E402
from repro_torch.launch import segment_cost, steps  # noqa: E402
from repro_torch.models import api, lm  # noqa: E402
from repro_torch.optim import optimizer as opt_mod  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

OPT = opt_mod.AdamWConfig()
# one arch of each family
FAMILIES = {"dense": "qwen3-0.6b", "vlm": "internvl2-26b",
            "moe": "phi3.5-moe-42b-a6.6b", "hybrid": "recurrentgemma-2b",
            "ssm": "rwkv6-7b", "encdec": "seamless-m4t-large-v2"}
KINDS = ("train", "prefill", "decode")
SMOKE = dict(seq=16, batch=4)


def _smoke_shape(kind: str) -> ShapeSpec:
    return ShapeSpec("smoke", SMOKE["seq"], SMOKE["batch"], kind)


# -- model FLOPs --------------------------------------------------------------
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equals_the_reference(arch, shape):
    assert segment_cost.model_flops(get_config(arch), SHAPES[shape]) == \
        jseg.model_flops(J_ARCHS[arch], J_SHAPES[shape])


# -- the walk's state bytes at full width -------------------------------------
STATE_CELLS = [(a, m) for a in FAMILIES.values()
               for m in ("1x1", "1x2", "2x2")] + [("qwen3-32b", "16x16")]


@pytest.mark.parametrize("arch,mesh", STATE_CELLS)
def test_walked_param_and_optimizer_bytes_at_full_width(arch, mesh):
    """A training cell's rank holds 4 bytes a parameter of
    ``sharding.rank_param_count`` (the f32 masters of its cut: its model
    slice, and at D > 1 its 1/D of every data-cut leaf), twice that of
    AdamW moments plus the 4-byte step, and as many gradient bytes as
    master bytes."""
    cfg = get_config(arch)
    data, model = steps.parse_mesh(mesh)
    cell = dryrun.run_cell(arch, "train_4k", mesh, skip_segments=True)
    plan = sharding.train_plan(cfg, cell["rank"], data, model)
    n = sharding.rank_param_count(cfg, plan.split, plan.dcut)
    mem = cell["memory"]
    assert mem["params"] == 4 * n
    assert mem["optimizer"] == 2 * mem["params"] + 4
    assert mem["gradients"] == mem["params"]
    assert cell["rows"] == SHAPES["train_4k"].global_batch // data


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "seamless-m4t-large-v2"])
def test_serve_structs_are_the_whole_model_and_specs_a_rank(arch):
    """``serve_structs`` holds the whole model in the compute dtype (2
    bytes a parameter, no f32 master), the batch without labels (an
    encdec config's source embeddings beside) and the dense cache;
    ``serve_specs`` at 1x1 is the same trees, and at 1x2 a rank's half
    of the kv heads' cache."""
    cfg, shape = get_config(arch), SHAPES["decode_32k"]
    params, batch, cache = steps.serve_structs(cfg, shape)
    assert segment_cost.tree_bytes(params) == 2 * sharding.rank_param_count(
        cfg, sharding.plan(cfg, 0, 1))
    assert "labels" not in batch
    assert ("src_embeds" in batch) == bool(cfg.n_encoder_layers)
    (p1, b1, c1), local = steps.serve_specs(cfg, shape)
    assert local is cfg
    shapes = lambda t: [(tuple(x.shape), x.dtype) for x in  # noqa: E731
                        tree_mod.leaves(t)]
    assert shapes(p1) == shapes(params) and shapes(c1) == shapes(cache)
    (_, _, c2), local2 = steps.serve_specs(cfg, shape, 1, 2)
    assert local2.n_kv_heads * 2 == cfg.n_kv_heads
    assert segment_cost.tree_bytes(c2) * 2 == segment_cost.tree_bytes(cache)


# -- a walk's FLOPs against FlopCounterMode on the CPU ------------------------
def _cpu_params(cfg):
    return weights.seeded_params(cfg, 0, "cpu")


def _cpu_batch(cfg, shape):
    g = torch.Generator().manual_seed(0)
    b = {k: (torch.randint(0, cfg.vocab_size, tuple(v.shape),
                           generator=g).to(v.dtype)
             if not v.dtype.is_floating_point else
             torch.randn(tuple(v.shape), generator=g).to(v.dtype))
         for k, v in api.batch_struct(cfg, shape).items()}
    return b


def _card_flash(monkeypatch):
    """The CPU's flash attention through the card's autograd (the
    kernel's forward as its plain version, the backward's plain
    recompute), so a CPU step dispatches what the card's does."""
    monkeypatch.setattr(ops._fa, "flash_attention",
                        lambda q, k, v, causal, window: ref.flash_attention(
                            q, k, v, causal=causal, window=window))
    monkeypatch.setattr(ops, "flash_attention",
                        lambda q, k, v, *, causal=True, window=None:
                        ops._FlashAttention.apply(q, k, v, causal, window))


def _cpu_flops(cfg, kind: str) -> int:
    shape = _smoke_shape(kind)
    params = _cpu_params(cfg)
    batch = _cpu_batch(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            state = {"params": params, "opt": opt_mod.init_state(OPT,
                                                                 params)}
            loss, grads = steps.loss_and_grads(params, cfg, batch)
            opt_mod.update(OPT, grads, state["opt"], params)
            return fc.get_total_flops()
        cast = weights.cast_params(params, cfg)
        with torch.no_grad():
            if kind == "prefill":
                batch.pop("labels", None)
                steps.make_prefill_step(cfg, shape.seq_len)(cast, batch)
            else:
                cache = lm.init_cache(cfg, shape.global_batch,
                                      shape.seq_len, "cpu",
                                      shape.seq_len
                                      if cfg.n_encoder_layers else None)
                steps.make_decode_step(cfg)(
                    cast, torch.zeros((shape.global_batch, 1),
                                      dtype=torch.int32),
                    cache, torch.tensor(3, dtype=torch.int32))
    return fc.get_total_flops()


def _walk(cfg, kind: str, mesh=(1, 1)):
    shape = _smoke_shape(kind)
    if kind == "train":
        return segment_cost.train_step_walk(cfg, OPT, shape, *mesh)[0]
    return segment_cost.serve_step_walk(cfg, shape, *mesh)[0]


FLOP_CASES = [(a, k) for a in FAMILIES.values() for k in KINDS] + [
    ("qwen3-0.6b/bf16-dots", "train")]


def _cfg(name: str):
    arch, _, variant = name.partition("/")
    cfg = smoke_config(get_config(arch))
    if variant:                 # the full-width configs' dtype and remat
        cfg = dataclasses.replace(cfg, dtype="bfloat16", remat="dots")
    return cfg


@pytest.mark.parametrize("name,kind", FLOP_CASES)
def test_walk_flops_equal_flop_counter_on_cpu(monkeypatch, name, kind):
    """The step walked on ``meta`` (each hand kernel one op, its FLOPs
    its plain version's) counts exactly the FLOPs ``FlopCounterMode``
    counts over the same step on real CPU tensors, the CPU's flash
    attention taking the card's autograd (its backward recomputes the
    forward, as the card's does)."""
    cfg = _cfg(name)
    _card_flash(monkeypatch)
    want = _cpu_flops(cfg, kind)
    assert want > 0
    assert _walk(cfg, kind).flops == want


# -- segments against the whole step ------------------------------------------
SEGMENT_CASES = [(a, k, m) for a in FAMILIES.values() for k in KINDS
                 for m in ((1, 2), (2, 2))] + [
    ("qwen3-0.6b/bf16-dots", "train", (1, 1))]


@pytest.mark.parametrize("name,kind,mesh", SEGMENT_CASES)
def test_segments_times_counts_add_up_to_the_whole_step(name, kind, mesh):
    """A cell's segments times their counts (``reduced`` the serving
    head) give the whole-step walk's FLOPs and collective bytes by kind
    exactly, and its HBM bytes within 1e-5: a block program's units each
    keep a scalar router-loss sum, and the loss's backward starts from a
    scalar one, a few bytes a unit that a layer walked alone as its own
    unit does not count the same way.  A training cell's ``cast``
    segment carries the work of the stacks: each stacked leaf's cast and
    each layer's gradient accumulated into it."""
    cfg = _cfg(name)
    shape = _smoke_shape(kind)
    if kind == "train":
        cell = segment_cost.train_cell(cfg, OPT, shape, *mesh)
    else:
        cell = segment_cost.serve_cell(cfg, shape, *mesh)
    whole = _walk(cfg, kind, mesh)
    tot = cell["totals"]
    assert tot["flops_per_dev"] == whole.flops
    assert tot["coll_breakdown"] == whole.coll_breakdown
    assert abs(tot["hbm_bytes_per_dev"] - whole.bytes_hbm) \
        <= 1e-5 * whole.bytes_hbm


# -- the kernels' meta route --------------------------------------------------
def _kernel_inputs(name: str, device: str):
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(device)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=g,
                             dtype=torch.int32).to(device)

    h, w = rnd(3, 64), rnd(64, 300)
    if name in ("fused_argmax_head_with_value", "fused_argmax_head"):
        return (h, w), {}
    if name == "fused_topk_head":
        return (h, w, 5), {}
    if name in ("verify_draft", "verify_draft_with_value"):
        return (rnd(2, 4, 64), w, ints(300, 2, 3)), {}
    if name.startswith("paged_attention"):
        mode = name.partition(":")[2]
        tables = torch.arange(6, dtype=torch.int32).reshape(2, 3).to(device)
        return (rnd(2, 4, 64), rnd(6, 64, 2, 64), rnd(6, 64, 2, 64),
                tables, torch.tensor([100, 191], dtype=torch.int32).to(
                    device)), {"attn_approx": mode}
    if name == "flash_attention":
        return (rnd(2, 4, 8, 32), rnd(2, 2, 8, 32), rnd(2, 2, 8, 32)), {
            "window": 5}
    if name == "flash_attention_backward":
        return (rnd(2, 4, 8, 32), rnd(2, 2, 8, 32), rnd(2, 2, 8, 32),
                rnd(2, 4, 8, 32)), {}
    if name == "softmax_xent":
        return (rnd(5, 300), ints(300, 5)), {}
    return (rnd(5, 300),), {}             # softmax_stats, online_softmax


KERNEL_OPS = ["fused_argmax_head_with_value", "fused_argmax_head",
              "fused_topk_head", "verify_draft", "verify_draft_with_value",
              *(f"paged_attention:{m}" for m in ("exact", "base2", "pseudo",
                                                 "pwl", "maxonly")),
              "flash_attention", "flash_attention_backward",
              "softmax_stats", "online_softmax", "softmax_xent"]


def _meta_like(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x


@pytest.mark.parametrize("name", KERNEL_OPS)
def test_kernel_meta_route_matches_the_plain_version(name):
    """Each entry of ``kernels.ops`` on ``meta`` tensors gives its CPU
    plain version's output shapes and dtypes, and ``FlopCounterMode``
    counts the same FLOPs on both; a hand kernel is one op of the
    ``repro_torch_meta`` library, counted its inputs read and its
    outputs written once."""
    fn = getattr(ops, name.partition(":")[0])
    args, kw = _kernel_inputs(name, "cpu")
    with FlopCounterMode(display=False) as fc:
        want = fn(*args, **kw)
    margs = [_meta_like(a) for a in args]
    with hlo_stats.Counter() as c:
        got = fn(*margs, **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    assert c.flops == fc.get_total_flops()
    if name != "flash_attention_backward":
        io = sum(t.numel() * t.element_size()
                 for t in [*margs, *got] if isinstance(t, torch.Tensor))
        if name == "fused_argmax_head":      # the value output dropped
            io += got[0].shape[0] * 4
        assert c.bytes == io


def test_paged_meta_route_holds_the_split_partials():
    """On ``meta`` the paged entry allocates the CUDA wrapper's split
    partials (rows x (hd + 2) f32 for a table over several chunks) and
    the pre-pass maxima of base2 / pwl, live across the kernel's op."""
    args, kw = _kernel_inputs("paged_attention:base2", "meta")
    n_chunks, _ = ops._pa.split_for(args[0], args[1], args[3])
    assert n_chunks > 1
    rows = 2 * 4 * n_chunks
    with hlo_stats.Counter() as c:
        ops.paged_attention(*args, **kw)
    assert c.peak == rows * (64 + 2) * 4 + rows * 4 + 2 * 4 * 64 * 4


def test_other_devices_still_raise():
    for dev in ("xpu", "mps"):
        fake = types.SimpleNamespace(device=torch.device(dev))
        with pytest.raises(ValueError, match="device type"):
            ops._device_type(fake)
    with pytest.raises(ValueError, match="several devices"):
        ops._device_type(torch.empty(1), torch.empty(1, device="meta"))
    assert ops._device_type(torch.empty(1, device="meta")) == "meta"


def test_meta_library_covers_every_kernel():
    assert set(meta.OPERATORS) == {
        "flash_attention", "paged_attention", "fused_argmax_head",
        "fused_verify_head", "fused_topk_head", "softmax_stats",
        "online_softmax", "fused_xent"}


# -- the vocabulary-parallel loss's static label pick -------------------------
class _OneRank:
    """A group of one rank on the CPU (the loss's collectives as
    identities)."""
    rank, world = 0, 1

    def all_gather(self, x, kind):
        return x[None].clone()

    def all_reduce_sum(self, x, kind):
        return x


def test_vocab_parallel_backward_takes_off_the_label_in_static_shapes():
    """The backward's static-shape label pick (every row takes off
    ``mine`` at its clamped column) gives, bit for bit, what picking the
    rows that hold their label with ``torch.nonzero`` gave."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(6, 7, generator=g)
    lo = 3
    labels = torch.tensor([3, 9, 0, 5, 12, 4])      # 3 rows outside
    xg = x.clone().requires_grad_(True)
    loss = api.vocab_parallel_xent(xg, labels, _OneRank(), lo)
    gout = torch.randn(6, generator=g)
    (got,) = torch.autograd.grad(loss, xg, gout)
    m, l = ref.softmax_stats(x)
    lse = m + torch.log(l)
    local = labels - lo
    mine = (local >= 0) & (local < 7)
    p = ref.online_softmax(x) * (l * torch.exp(m - lse))[:, None]
    rows = torch.nonzero(mine).reshape(-1)
    p[rows, local[rows]] -= 1
    p.mul_(gout[:, None])
    assert torch.equal(got, p)


# -- cells and the table ------------------------------------------------------
def test_reduced_head_counts_fewer_bytes_than_the_softmax_head():
    cell = dryrun.run_cell("qwen3-0.6b", "decode_32k", "1x1")
    seg = cell["segments"]
    assert seg["head_reduced"]["hbm_bytes_per_dev"] < \
        seg["head_softmax"]["hbm_bytes_per_dev"]
    assert cell["useful_flops_ratio"] > 0
    assert set(cell["memory"]) == {"params", "optimizer", "gradients",
                                   "cache", "activations", "total"}


def test_cells_that_do_not_run_are_written_as_such(tmp_path, capsys):
    dryrun.main(["--arch", "starcoder2-7b", "--shape", "train_4k",
                 "--mesh", "single", "--out", str(tmp_path)])
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    err = json.loads((tmp_path / "starcoder2-7b__train_4k__single.json")
                     .read_text())
    assert "n_heads=36 does not divide by the world size 16" in err["error"]
    skip = json.loads((tmp_path / "qwen3-0.6b__long_500k__single.json")
                      .read_text())
    assert skip["skipped"].startswith("pure full-attention arch")
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    assert "[skip]" in capsys.readouterr().out


def test_roofline_prints_a_row_for_each_record(tmp_path, capsys):
    ok = {"arch": "qwen3-0.6b", "shape": "train_4k", "mesh": "2x2",
          "memory": {"total": 12.5e9}, "fits_h100_80g": True,
          "useful_flops_ratio": 0.66,
          "totals": {"t_compute_s": 2.0, "t_memory_s": 38.0,
                     "t_collective_s": 0.17, "t_bound_s": 38.0,
                     "bottleneck": "memory"}}
    for name, rec in (("a", ok), ("b", dict(ok, mesh="single",
                                             skipped="why: because")),
                      ("c", dict(ok, mesh="single", error="no"))):
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    roofline.main(["--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("| arch | shape | mesh |")
    assert out[2] == ("| qwen3-0.6b | train_4k | 2x2 | 2.00e+00 | 3.80e+01 | "
                      "1.70e-01 | memory | 3.80e+01 | 0.66 | 12.50 | yes |")
    assert "SKIP (why)" in out[3] and "ERROR" in out[4]
    roofline.main(["--out", str(tmp_path), "--mesh", "2x2"])
    assert len(capsys.readouterr().out.splitlines()) == 3
