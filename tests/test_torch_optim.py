"""The port's AdamW and gradient compression
(``repro_torch.optim``) against the JAX package's
(``repro.optim.optimizer``, ``repro.optim.compression``).

Tolerances: ``update`` over three steps on one param / gradient tree --
params, moments (f32 at rtol 1e-6; bf16 moments to one bf16 step,
2^-8 relative) and metrics (rtol 1e-6) -- the two frameworks round the
same f32 expressions, but XLA may fuse a multiply-add or sum a leaf in
another order.  ``schedule`` at rtol 1e-6.  ``compress``: the int8
values and the scales bit-equal, the residual within one f32 ulp of its
block's scale; ``decompress`` bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import optimizer as jopt  # noqa: E402
from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim import optimizer as topt  # noqa: E402

# a stacked (L, D) norm scale (decayed and, factored, factored over (L,
# D)), a stacked matrix, a 1-D bias, a (1, n) row that cannot factor
SHAPES = {"ln": (3, 8), "w": (3, 8, 6), "b": (6,), "row": (1, 5)}


def _trees(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": {k: (rng.normal(size=s) * scale).astype(np.float32)
                  for k, s in SHAPES.items()},
            "list": [(rng.normal(size=(4, 4)) * scale).astype(np.float32)]}


def _walk(a, b, path=()):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            yield from _walk(a[k], b[k], path + (k,))
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _walk(x, y, path + (i,))
    else:
        yield path, np.asarray(a.astype(jnp.float32)
                               if hasattr(a, "astype") else a), b


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_update_matches_reference_over_three_steps(factored, state_dtype,
                                                   clip):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip,
              factored=factored, state_dtype=state_dtype)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    params = _trees(0)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init_state(jcfg, jp)
    tp = tree_mod.map_tree(lambda _, a: torch.from_numpy(a.copy()), params)
    ts = topt.init_state(tcfg, tp)
    rtol = 1e-6 if state_dtype == "float32" else 2.0 ** -8
    for i in range(3):
        grads = _trees(10 + i, scale=0.3)
        jp, js, jm = jopt.update(jcfg, jax.tree.map(jnp.asarray, grads),
                                 js, jp)
        tm = topt.update(tcfg, tree_mod.map_tree(
            lambda _, a: torch.from_numpy(a), grads), ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-6, err_msg=f"{k} step {i}")
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    for path, want, got in _walk(jp, tp):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-7, err_msg=str(path))
    for path, want, got in _walk({"m": js["m"], "v": js["v"]},
                                 {"m": ts["m"], "v": ts["v"]}):
        assert str(got.dtype).endswith(
            "float32" if (path[-1] in ("vr", "vc") or
                          state_dtype == "float32") else "bfloat16"), path
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                                   atol=1e-12, err_msg=str(path))
    if factored:     # the stacked (L, D) scale factors over (L, D)
        assert set(ts["v"]["a"]["ln"]) == {"vr", "vc"}
        assert not isinstance(ts["v"]["a"]["row"], dict)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_update_in_chunks_is_the_whole_leaf_update_bitwise(monkeypatch,
                                                           state_dtype):
    """A leaf larger than ``UPDATE_CHUNK`` is updated a chunk of its flat
    view at a time (the update's temporaries a few chunks, not a few
    leaves: a phi3.5-moe expert stack is 1.68 GB in f32); the update is
    elementwise, so three steps in chunks of 7 elements (none dividing
    a leaf) give the params, moments and metrics of the whole-leaf
    update bit for bit, weight decay judged on the whole leaf."""
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                           clip_norm=0.5, state_dtype=state_dtype)
    runs = []
    for chunk in (topt.UPDATE_CHUNK, 7):
        monkeypatch.setattr(topt, "UPDATE_CHUNK", chunk)
        tp = tree_mod.map_tree(lambda _, a: torch.from_numpy(a.copy()),
                               _trees(0))
        ts = topt.init_state(cfg, tp)
        ms = [topt.update(cfg, tree_mod.map_tree(
            lambda _, a: torch.from_numpy(a), _trees(10 + i, scale=0.3)),
            ts, tp) for i in range(3)]
        runs.append((tp, ts, ms))
    (pa, sa, ma), (pb, sb, mb) = runs
    for a, b in zip(tree_mod.leaves({"p": pa, "s": sa}),
                    tree_mod.leaves({"p": pb, "s": sb})):
        assert torch.equal(a, b)
    for x, y in zip(ma, mb):
        assert torch.equal(x["grad_norm"], y["grad_norm"])


@pytest.mark.parametrize("step", [0, 1, 9, 10, 11, 55, 100, 101, 140])
def test_schedule_matches_reference_at_its_edges(step):
    """Warm-up start and end, the cosine's start, middle, end and past
    its end."""
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = float(jopt.schedule(jopt.AdamWConfig(**cfg), jnp.int32(step)))
    got = topt.schedule(topt.AdamWConfig(**cfg),
                        torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_global_norm_and_clip_match_reference():
    grads = _trees(3, scale=4.0)
    jn = float(jopt.global_norm(jax.tree.map(jnp.asarray, grads)))
    tg = tree_mod.map_tree(lambda _, a: torch.from_numpy(a), grads)
    np.testing.assert_allclose(float(topt.global_norm(tg)), jn, rtol=1e-6)
    clipped, norm = topt.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(norm), jn, rtol=1e-6)
    np.testing.assert_allclose(float(topt.global_norm(clipped)), 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("shape,block", [((1000,), 256), ((7, 33), 64),
                                         ((4, 256), 256), ((3,), 256)])
def test_compress_and_decompress_match_reference(shape, block):
    rng = np.random.default_rng(sum(shape) + block)
    x = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 50.0],
                                              size=shape)).astype(np.float32)
    x.reshape(-1)[0] = 0.0
    jq, js, je = (np.asarray(a) for a in jcomp.compress(jnp.asarray(x),
                                                         block))
    tq, ts, te = tcomp.compress(torch.from_numpy(x), block)
    assert tq.dtype == torch.int8 and te.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    # one ulp of the block's scale bounds a residual's rounding
    ulp = np.spacing(np.repeat(js[:, 0], block)[:x.size]).reshape(shape)
    assert np.all(np.abs(te.numpy() - je) <= ulp)
    np.testing.assert_array_equal(
        tcomp.decompress(tq, ts, shape).numpy(),
        np.asarray(jcomp.decompress(jnp.asarray(jq), jnp.asarray(js),
                                    shape)))
