"""The port's hardware-softmax baselines (``repro_torch.core.
softmax_variants``) against the JAX package's, on the same numpy inputs.

Tolerances: f32 units agree at rtol 1e-6 (the two frameworks' exp,
exp2 and sums differ in the last bits).  The LUT tables are built by
each framework's ``exp2``, and XLA's and PyTorch's differ by one unit in
the last place on some entries (neither is correctly rounded on all of
them), so a table is held within 1 ulp, and the base2 unit's LUT index
is held exactly: on inputs planted at half-bins both pick the entry that
rounding half to even gives.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import reduced_softmax_predict  # noqa: E402
from repro.core import softmax_variants as jsv  # noqa: E402
from repro_torch.core import softmax_variants as tsv  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-6
KEY = jax.random.PRNGKey(0)


def _x(seed, shape=(16, 37), scale=3.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _both(fn_name, x, **kw):
    got = getattr(tsv, fn_name)(torch.from_numpy(x), **kw).numpy()
    want = np.asarray(getattr(jsv, fn_name)(jnp.asarray(x), **kw))
    return got, want


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name", ["softmax_unit", "log_softmax_unit",
                                  "base2_softmax_unit",
                                  "pseudo_softmax_unit",
                                  "inverse_softmax_unit"])
@pytest.mark.parametrize("axis", [-1, 0])
def test_units_match_jax(name, axis):
    x = _x(1)
    got, want = _both(name, x, axis=axis)
    # log s(x) = z - log sum e^z cancels two terms as large as the
    # inputs: its absolute error is an ulp of max |x|, not of the result
    atol = RTOL * np.abs(x).max() if name == "log_softmax_unit" else 1e-7
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("name", sorted(jsv.PREDICT_FNS))
@pytest.mark.parametrize("scale", [0.1, 1.0, 10.0, 80.0])
def test_predict_fns_match_jax(name, scale):
    x = _x(2, shape=(64, 50), scale=scale)
    got = tsv.PREDICT_FNS[name](torch.from_numpy(x)).numpy()
    want = np.asarray(jsv.PREDICT_FNS[name](jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    assert set(tsv.PREDICT_FNS) == set(jsv.PREDICT_FNS)


def test_base2_precision_and_log2e():
    got, want = _both("base2_softmax_unit", _x(3), precision_bits=4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    assert tsv.LOG2E == jsv.LOG2E


@pytest.mark.parametrize("bits", [4, 8, 12])
def test_base2_frac_lut_matches_jax(bits):
    got = tsv.base2_frac_lut(bits).numpy()
    want = np.asarray(jsv.base2_frac_lut(bits))
    assert got.dtype == np.float32 and got.shape == (1 << bits,)
    assert _ulps(got, want).max() <= 1
    assert got[0] == 1.0 and np.all(np.diff(got) > 0)


@pytest.mark.parametrize("bits", [4, 8])
def test_base2_exp_raw_picks_the_jax_lut_index(bits):
    """Inputs planted at LUT half-bins (v * 2^P = k + 1/2, which rounds
    half to even) and at v -> 1 (the index clips to the last entry, not
    to 2^P): both packages read the same entry of their own LUT."""
    size = 1 << bits
    k = np.arange(size)
    n = np.array([-3.0, 0.0, 2.0], np.float32)
    # y = n + v built in f32 exactly, then x = y / log2e; recover the y
    # each framework sees and plant again from it so v is exact
    v = ((k + 0.5) / size).astype(np.float32)
    y = (n[:, None] + v[None, :]).astype(np.float32).ravel()
    y = np.concatenate([y, np.float32(1.0) - np.float32(2.0 ** -20)
                        + np.array([0.0, -1.0, -5.0], np.float32)])
    x = (y.astype(np.float64) / jsv.LOG2E).astype(np.float32)
    xt = torch.from_numpy(x)
    yt = (xt * tsv.LOG2E).numpy()
    yj = np.asarray(jnp.asarray(x) * jsv.LOG2E)
    np.testing.assert_array_equal(yt, yj)
    nn = np.floor(yt)
    idx = np.clip(np.round((yt - nn) * size).astype(np.int64), 0, size - 1)
    assert np.any((yt - nn) * size % 1 == 0.5)      # real half-bins
    assert np.any(idx == size - 1)
    got = tsv.base2_exp_raw(xt, precision_bits=bits).numpy()
    want = np.asarray(jsv.base2_exp_raw(jnp.asarray(x), precision_bits=bits))
    t_lut = tsv.base2_frac_lut(bits).numpy()
    j_lut = np.asarray(jsv.base2_frac_lut(bits))
    np.testing.assert_array_equal(got, np.exp2(nn) * t_lut[idx])
    np.testing.assert_array_equal(want, np.exp2(nn) * j_lut[idx])
    # the planted k + 1/2 with k even are where half to even (k) and
    # half away from zero (k + 1) part: the equalities above hold there
    half = ((yt - nn) * size % 1) == 0.5
    assert np.any(half & (np.floor((yt - nn) * size) % 2 == 0))


def test_cordic_exp_matches_jax():
    x = np.linspace(-12.0, 6.0, 1001).astype(np.float32)
    got, want = _both("cordic_exp", x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, np.exp(x.astype(np.float64)),
                               rtol=1e-5)
    got, want = _both("cordic_exp", x, iterations=12)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_inverse_softmax_with_cordic_matches_jax():
    x = _x(4, scale=2.0)
    got = tsv.inverse_softmax_unit(torch.from_numpy(x),
                                   exp_fn=tsv.cordic_exp).numpy()
    want = np.asarray(jsv.inverse_softmax_unit(jnp.asarray(x),
                                               exp_fn=jsv.cordic_exp))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert np.array_equal(
        tsv.predict_inverse_softmax(torch.from_numpy(x),
                                    exp_fn=tsv.cordic_exp).numpy(),
        np.argmax(x, -1))


@pytest.mark.parametrize("lo,hi", [(-100.0, 0.0), (0.0, 100.0), (-1.0, 1.0)])
@pytest.mark.parametrize("name", sorted(jsv.PREDICT_FNS))
def test_theorem1_table1_regimes(name, lo, hi):
    """Theorem 1 through every port unit on the inputs of the JAX
    package's Table I test: the unit's class is the comparator's."""
    x = np.array(jax.random.uniform(KEY, (64, 10), minval=lo, maxval=hi))
    got = tsv.PREDICT_FNS[name](torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(reduced_softmax_predict(
        jnp.asarray(x))))


@pytest.mark.parametrize("name", sorted(jsv.PREDICT_FNS))
def test_theorem1_all_units_agree_with_reduced(name):
    """The inputs of ``test_all_units_agree_with_reduced``: normal rows
    at scales 0.1 to 80."""
    for i, scale in enumerate([0.1, 1.0, 10.0, 80.0]):
        x = np.array(jax.random.normal(jax.random.fold_in(KEY, i),
                                       (128, 50)) * scale)
        got = tsv.PREDICT_FNS[name](torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(reduced_softmax_predict(jnp.asarray(x))),
            err_msg=f"{name} scale={scale}")
