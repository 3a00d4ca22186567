"""The port's keyed generator (``repro_torch.prng``) against
``jax.random`` (jax 0.9, threefry in its partitionable mode, 64-bit
types off), on the CPU.

Keys, ``fold_in``, ``split``, the random bits and the uniforms are
integer work and a fused multiply-add, so they must be EQUAL bit for
bit.  ``gumbel`` ends in two ``log``s, which torch and XLA may round an
ulp apart: the noise must agree to one f32 ulp at its own scale (the
spacing of max(|g|, 1): below 1 a unit error of the inner ``log`` is an
absolute 2**-23).  ``categorical``, ``core.topk_sample`` and the
samplers' keyed draws must pick the same index as JAX's on seeded
logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.serve import sampler as jsampler  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.serve import sampler as tsampler  # noqa: E402

SEEDS = [0, 5, 123456, 2 ** 31 - 1, 2 ** 32 + 3]
SHAPES = [(2,), (151,), (4, 8)]


@pytest.fixture(autouse=True, scope="module")
def _partitionable():
    """The mode the port is written from (jax 0.9's default), pinned."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _t(key) -> torch.Tensor:
    return torch.as_tensor(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equals_prngkey(seed):
    assert torch.equal(prng.key(seed), _t(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 7, 100003, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_fold_in_equals_jax(seed, data):
    got = prng.fold_in(prng.key(seed), data)
    assert torch.equal(got, _t(jax.random.fold_in(
        jax.random.PRNGKey(seed), data)))


def test_fold_in_refuses_data_past_uint32():
    with pytest.raises(OverflowError):
        prng.fold_in(prng.key(0), 2 ** 32)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.key(0), -1)


@pytest.mark.parametrize("num", [2, 3, 8])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed, num):
    got = prng.split(prng.key(seed), num)
    assert torch.equal(got, _t(jax.random.split(jax.random.PRNGKey(seed),
                                                num)))


def test_split_batched_equals_vmap():
    """A (R, 2) batch of keys splits row by row, as ``jax.vmap(split)``
    (the device loop's per-row split)."""
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    assert torch.equal(prng.split(_t(keys)),
                       _t(jax.vmap(jax.random.split)(keys)))


def test_split_chain_matches_engine_use():
    """Eight draws' worth of (next, use) pairs down one request's chain,
    as both engines split once per emitted token."""
    jk, tk = jax.random.fold_in(jax.random.PRNGKey(0), 11), prng.fold_in(
        prng.key(0), 11)
    for _ in range(8):
        jn, ju = jax.random.split(jk)
        tn, tu = prng.split(tk)
        assert torch.equal(tu, _t(ju))
        jk, tk = jn, tn
    assert torch.equal(tk, _t(jk))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_equal_jax(seed, shape):
    got = prng.random_bits(prng.key(seed), shape)
    want = jax.random.bits(jax.random.PRNGKey(seed), shape)
    assert torch.equal(got, _t(want))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (1.1754943508222875e-38, 1.0),
                                    (-2.0, 3.0)])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_equals_jax(seed, shape, bounds):
    lo, hi = bounds
    got = prng.uniform(prng.key(seed), shape, lo, hi).numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         minval=lo, maxval=hi))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _ulps_at_scale(got: np.ndarray, want: np.ndarray) -> float:
    scale = np.maximum(np.abs(want), np.float32(1.0)).astype(np.float32)
    return float((np.abs(got.astype(np.float64) - want)
                  / np.spacing(scale)).max())


@pytest.mark.parametrize("shape", SHAPES + [(4096,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_one_ulp(seed, shape):
    got = prng.gumbel(prng.key(seed), shape).numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    assert got.shape == want.shape and got.dtype == np.float32
    assert _ulps_at_scale(got, want) <= 1.0


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_one_key_equals_jax(seed):
    """One key over (B, n) logits: the draw's counts run over the whole
    matrix."""
    logits = np.random.default_rng(seed).standard_normal(
        (4, 151)).astype(np.float32)
    got = prng.categorical(prng.key(seed), torch.from_numpy(logits))
    want = jax.random.categorical(jax.random.PRNGKey(seed), logits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_row_keys_equal_vmap(seed):
    """A key per row, as ``jax.vmap(jax.random.categorical)`` draws in
    the device loop."""
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((6, 256))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), 6)
    got = prng.categorical(_t(keys), torch.from_numpy(logits))
    want = jax.vmap(jax.random.categorical)(keys, logits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_lowest_index_wins_ties():
    """Equal perturbed logits resolve to the lowest index, as jnp.argmax:
    with -inf everywhere but two equal columns fed the same noise."""
    logits = torch.full((1, 8), -float("inf"))
    logits[0, 2] = logits[0, 5] = 0.0
    k = prng.key(0)
    g = prng.gumbel(k, (1, 8))
    # plant the tie: the same perturbed value in both columns
    logits[0, 5] = (g[0, 2] - g[0, 5]).item()
    want = int(jnp.argmax(jnp.asarray((g + logits).numpy()), axis=-1)[0])
    assert int(prng.categorical(k, logits)[0]) == want


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_topk_sample_equals_jax(seed, temperature):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((5, 300)).astype(np.float32)
    jv, ji = jcore.reduced_topk(jnp.asarray(x), 8)
    tv, ti = tcore.reduced_topk(torch.from_numpy(x), 8)
    want = jcore.topk_sample(jv, ji, jax.random.PRNGKey(seed), temperature)
    got = tcore.topk_sample(tv, ti, prng.key(seed), temperature)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bus(seed, b=6, v=512, k=8):
    x = np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32)
    vals, idxs = jcore.reduced_topk(jnp.asarray(x), k)
    return x, np.array(vals), np.array(idxs)


@pytest.mark.parametrize("sampler", [
    ("TopK", dict(k=8, temperature=0.8)),
    ("TopK", dict(k=8, temperature=0.8, sample_k=3)),
    ("TopK", dict(k=8, temperature=0.0)),
    ("Temperature", dict(temperature=0.7)),
    ("Temperature", dict(temperature=0.0)),
    ("Greedy", {}),
    ("SoftmaxBaseline", {}),
])
def test_pick_keyed_equals_jax(sampler):
    """``pick_keyed`` on one shared head output and key: the JAX
    sampler's token, row by row."""
    name, kw = sampler
    js, ts = getattr(jsampler, name)(**kw), getattr(tsampler, name)(**kw)
    x, vals, idxs = _bus(1)
    out = ((vals, idxs) if name == "TopK" else
           x if name == "Temperature" else np.argmax(x, -1).astype(np.int32))
    tout = (tuple(torch.tensor(o) for o in out) if name == "TopK"
            else torch.tensor(out))
    key = jax.random.PRNGKey(9)
    for row in range(x.shape[0]):
        key, use = jax.random.split(key)
        assert ts.pick_keyed(tout, row, _t(use)) \
            == js.pick_keyed(out, row, use)


@pytest.mark.parametrize("name", ["TopK", "Temperature"])
def test_device_draw_equals_vmap(name):
    """The device loop's batched draw (one key per row) against the JAX
    sampler's ``vmap(categorical)``, on a shared head output: the
    ``sample_device`` ops after the head."""
    ts = getattr(tsampler, name)(**({"k": 8, "temperature": 0.8}
                                    if name == "TopK" else
                                    {"temperature": 0.7}))
    x, vals, idxs = _bus(2)
    keys = jax.random.split(jax.random.PRNGKey(4), x.shape[0])
    if name == "TopK":
        z = (jnp.asarray(vals) / 0.8).astype(jnp.float32)
        c = jax.vmap(jax.random.categorical)(keys, z)
        want = np.take_along_axis(idxs, np.asarray(c)[:, None], 1)[:, 0]
        got = ts._draw(torch.from_numpy(vals), torch.from_numpy(idxs),
                       _t(keys))
    else:
        want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(x) / 0.7)
        got = ts._draw(torch.from_numpy(x), _t(keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_full_vocab_row_draw_equals_jax():
    """One Temperature draw over a 151,936-wide row (qwen3's vocabulary),
    the size of a row on the card."""
    x = (4 * np.random.default_rng(7).standard_normal(
        (1, 151936))).astype(np.float32)
    use = jax.random.split(jax.random.PRNGKey(12))[1]
    want = jsampler.Temperature(0.7).pick_keyed(x, 0, use)
    got = tsampler.Temperature(0.7).pick_keyed(torch.from_numpy(x), 0,
                                               _t(use))
    assert got == want


def test_base_sampler_has_no_keyed_form():
    class HostOnly(tsampler.Sampler):
        pass

    with pytest.raises(NotImplementedError, match="no device sampling"):
        HostOnly().sample_device(None, None, None, None)
    with pytest.raises(NotImplementedError, match="keyed"):
        HostOnly().pick_keyed(None, 0, None)
