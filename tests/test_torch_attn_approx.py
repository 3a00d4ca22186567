"""The port's approximate-attention catalog (``repro_torch.core.
attn_approx``) and the paged attention's five score modes, on the CPU,
against the JAX package: its catalog, its Pallas kernel in interpret mode
and its plain version, on the same numpy inputs.

Tolerances: the plain paged attention against the Pallas kernel uses the
JAX package's own ``TOL`` (``tests/test_attn_approx.py``): exact, pseudo
and maxonly differ by float rounding only (5e-5); base2 and pwl evaluate
their LUT at a block's running max instead of the global max, so they
agree to one LUT bin or chord (2e-3).  Against the JAX plain version,
which computes the same dense formula, every mode agrees at 1e-5.  The
catalog's functions agree at rtol 2e-6 (f32): XLA's ``exp2`` on the CPU
is off by up to 1e-6 relative even at integers (2^-34 reads 1 - 1.0e-6
times the power of two), where PyTorch's is exact, and the two ``exp``s
differ in the last bits; tables built by each framework's ``exp2`` agree
within 1 ulp.  The engine and the probe are in
``test_torch_probe.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import attn_approx as japprox  # noqa: E402
from repro.core import softmax_variants as jsv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import attn_approx as approx  # noqa: E402
from repro_torch.core import softmax_variants as tsv  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

torch.set_num_threads(2)

TOL = {"exact": 5e-5, "pseudo": 5e-5, "maxonly": 5e-5,
       "base2": 2e-3, "pwl": 2e-3}
REF_TOL = 1e-5
RTOL = 2e-6
WINDOWS = [None, 1, 7, 8, 9, 100]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# ---------------------------------------------------------------------------
# Catalog / resolve
# ---------------------------------------------------------------------------
def test_resolve_and_catalog_match_jax():
    assert approx.VARIANTS == japprox.VARIANTS
    for name, entry in japprox.CATALOG.items():
        got = approx.CATALOG[name]
        for field in ("name", "description", "exp_free",
                      "order_preserving", "softmax_approx"):
            assert getattr(got, field) == getattr(entry, field), (name, field)
    for args in (("exact", None), ("maxonly", 8), (None, None),
                 ("pwl", 3.0)):
        assert approx.resolve(*args) == japprox.resolve(*args)
    with pytest.raises(ValueError, match="base2"):
        approx.resolve("nope", None)           # the error names the catalog
    for bad in (0, -3):
        with pytest.raises(ValueError):
            approx.resolve("exact", bad)
    assert (approx.MASK_FLOOR, approx.PWL_SEGMENTS,
            approx.BASE2_PRECISION_BITS) == (
        japprox.MASK_FLOOR, japprox.PWL_SEGMENTS,
        japprox.BASE2_PRECISION_BITS)


# ---------------------------------------------------------------------------
# The score functions
# ---------------------------------------------------------------------------
def _planted_d(segments):
    """d <= 0 on a dense grid plus points whose y = d*log2e sits at the
    edges and midpoints of every LUT bin / chord of the fractional
    part."""
    grid = np.linspace(-20.0, 0.0, 4001)
    k = np.arange(segments + 1)
    v = np.concatenate([k / segments, (k + 0.5) / segments])
    y = (np.array([-7.0, -2.0, -1.0])[:, None] + v[None, :]).ravel()
    return np.concatenate([grid, y / tsv.LOG2E]).astype(np.float32)


@pytest.mark.parametrize("name", ["exact", "pseudo", "base2", "pwl"])
def test_weight_exp_matches_jax(name):
    segments = {"base2": 1 << approx.BASE2_PRECISION_BITS}.get(
        name, approx.PWL_SEGMENTS)
    d = _planted_d(segments)
    got = approx.weight_exp(torch.from_numpy(d), name).numpy()
    want = np.asarray(japprox.weight_exp(jnp.asarray(d), name))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    e = np.exp(d.astype(np.float64))
    if name in ("base2", "pwl"):        # the documented resolution
        assert np.max(np.abs(got - e)) < {"base2": 4e-3, "pwl": 3e-4}[name]
    with pytest.raises(ValueError):
        approx.weight_exp(torch.from_numpy(d), "maxonly")


def test_pwl_exp2_at_chord_edges_matches_jax():
    """At a chord's endpoints the unit returns the ROM entry times 2^n;
    in between, the chord.  Held against JAX on planted edges."""
    y = np.concatenate([np.arange(-3, 2) + j / 16 for j in range(17)]
                       + [np.linspace(-4, 1, 1001)]).astype(np.float32)
    got = approx.pwl_exp2_raw(torch.from_numpy(y)).numpy()
    want = np.asarray(japprox.pwl_exp2_raw(jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got, np.exp2(y.astype(np.float64)),
                               rtol=3e-4)


@pytest.mark.parametrize("name", ["exact", "pseudo"])
def test_carry_scale_matches_jax(name):
    dm = np.linspace(-30.0, 0.0, 301).astype(np.float32)
    got = approx.carry_scale(torch.from_numpy(dm), name).numpy()
    want = np.asarray(japprox.carry_scale(jnp.asarray(dm), name))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    for other in ("base2", "pwl", "maxonly"):   # exact rescale in base e
        np.testing.assert_array_equal(
            approx.carry_scale(torch.from_numpy(dm), other).numpy(),
            approx.carry_scale(torch.from_numpy(dm), "exact").numpy())


@pytest.mark.parametrize("name", approx.VARIANTS)
@pytest.mark.parametrize("axis", [-1, 1])
def test_attn_weights_and_score_error_match_jax(name, axis):
    rng = np.random.default_rng(3)
    s = (rng.normal(size=(4, 33, 5)) * 3).astype(np.float32)
    s[0, 20:] = -1e30                        # masked lanes, as the plain
    s[1, :, 2] = -np.inf                     # version and the kernel mask
    s[2, 5] = s[2, 9]                        # planted tie (maxonly: first)
    got = approx.attn_weights(torch.from_numpy(s), name, axis).numpy()
    want = np.asarray(japprox.attn_weights(jnp.asarray(s), name, axis))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    finite = s[3:]                           # no -inf row for the error
    err = float(approx.score_error(torch.from_numpy(finite), name, axis))
    jerr = float(japprox.score_error(jnp.asarray(finite), name, axis))
    assert abs(err - jerr) <= 1e-6
    if name == "exact":
        assert err == 0.0


def test_tables_equal_the_plain_versions_and_jax():
    """The kernel's ROMs (built by the wrapper) are the plain version's
    tables, and within 1 ulp of the JAX package's."""
    base2 = tpa._rom("base2", torch.device("cpu"))
    pwl = tpa._rom("pwl", torch.device("cpu"))
    assert tpa._rom("pseudo", torch.device("cpu")) is None
    assert base2.dtype == pwl.dtype == torch.float32
    assert base2.shape == (256,) and pwl.shape == (17,)
    assert torch.equal(base2, tsv.base2_frac_lut(8))
    assert torch.equal(pwl, approx.pwl_lut())
    assert _ulps(base2.numpy(), np.asarray(jsv.base2_frac_lut(8))).max() <= 1
    # pwl_exp2_raw's table, as the JAX package builds it
    jpwl = np.asarray(jnp.exp2(jnp.arange(17, dtype=jnp.float32) / 16))
    assert _ulps(pwl.numpy(), jpwl).max() <= 1
    assert set(tpa._MODES) == set(approx.CATALOG)
    assert set(tpa.paged_attention.launches_by_mode) == set(approx.CATALOG)


# ---------------------------------------------------------------------------
# The plain paged attention against the Pallas kernel (interpret)
# ---------------------------------------------------------------------------
def _variant_case(variant, window, multi):
    """The JAX package's (variant, window) case: a ragged batch (rows at
    3, 8, 23, 30), bs 8, g 2, pow-2 padded tables of permuted physical
    blocks; in the multi-token form each row is a 3-wide window."""
    bs, g, hkv, hd, t = 8, 2, 2, 16, 3
    rng = np.random.default_rng([approx.VARIANTS.index(variant),
                                 window or 0, int(multi)])
    last = np.array([3, 8, 23, 30])
    b = len(last)
    nb = int(last.max()) // bs + 1
    nblocks = b * nb + 3
    qshape = (b, t, g * hkv, hd) if multi else (b, g * hkv, hd)
    q = rng.normal(size=qshape).astype(np.float32)
    kp = rng.normal(size=(nblocks, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(nblocks, bs, hkv, hd)).astype(np.float32)
    rows = []
    for p in last:
        own = rng.choice(nblocks, p // bs + 1, replace=False)
        rows.append(np.concatenate([own, np.repeat(own[:1], nb - len(own))]))
    bt = np.stack(rows)
    nbb = 1 << (nb - 1).bit_length()
    bt = np.concatenate([bt, np.repeat(bt[:, :1], nbb - nb, axis=1)],
                        axis=1).astype(np.int32)
    pos = (np.maximum(last[:, None] - np.arange(t - 1, -1, -1), 0)
           if multi else last).astype(np.int32)
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("variant", approx.VARIANTS)
def test_plain_matches_pallas_per_variant_window(variant, window, multi):
    args = _variant_case(variant, window, multi)
    got = tops.paged_attention(*(torch.from_numpy(a) for a in args),
                               attn_approx=variant, window=window).numpy()
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jops.paged_attention(
        *jargs, use_pallas=True, interpret=True, attn_approx=variant,
        window=window))
    plain = np.asarray(jref.paged_attention(
        *jargs, attn_approx=variant, window=window))
    np.testing.assert_allclose(got, pallas, rtol=TOL[variant],
                               atol=TOL[variant])
    np.testing.assert_allclose(got, plain, rtol=REF_TOL, atol=REF_TOL)


def test_maxonly_is_the_first_argmax_v_row():
    """maxonly's output is the V row of the first highest visible score
    (numpy argmax), with a planted exact tie that the first key wins --
    the comparator datapath, no weights."""
    bs, g, hd, hkv, pos, b = 8, 2, 16, 2, 21, 3
    rng = np.random.default_rng(11)
    nb = pos // bs + 1
    nblocks = b * nb + 3
    q = rng.normal(size=(b, g * hkv, hd)).astype(np.float32)
    kp = rng.normal(size=(nblocks, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(nblocks, bs, hkv, hd)).astype(np.float32)
    bt = np.stack([rng.choice(nblocks, nb, replace=False)
                   for _ in range(b)]).astype(np.int32)
    k = kp[bt].reshape(b, -1, hkv, hd)
    v = vp[bt].reshape(b, -1, hkv, hd)
    qg = q.reshape(b, hkv, g, hd)
    sc = np.einsum("bkgh,bskh->bkgs", qg, k[:, :pos + 1]) / np.sqrt(hd)
    # row 0: copy the winning key of (kv 0, head 0) to an earlier position,
    # so the two keys score exactly alike and the earlier one must win
    win = int(np.argmax(sc[0, 0, 0]))
    early = 0 if win else 1
    kp[bt[0, early // bs], early % bs, 0] = k[0, win, 0]
    vp[bt[0, early // bs], early % bs, 0] = v[0, win, 0] + 1.0
    k = kp[bt].reshape(b, -1, hkv, hd)
    v = vp[bt].reshape(b, -1, hkv, hd)
    sc = np.einsum("bkgh,bskh->bkgs", qg, k[:, :pos + 1]) / np.sqrt(hd)
    sel = np.argmax(sc, axis=-1)
    assert sel[0, 0, 0] == min(early, win)
    want = np.zeros((b, hkv, g, hd), np.float32)
    for i in range(b):
        for kv in range(hkv):
            for gg in range(g):
                want[i, kv, gg] = v[i, sel[i, kv, gg], kv]
    got = tops.paged_attention(
        *(torch.from_numpy(a) for a in (q, kp, vp, bt)),
        torch.full((b,), pos, dtype=torch.int32),
        attn_approx="maxonly").numpy()
    np.testing.assert_array_equal(got, want.reshape(b, g * hkv, hd))


def test_cpu_dispatch_runs_every_mode_plain_and_validates():
    """CPU tensors take the plain version in every mode (no launch); the
    CUDA wrapper refuses them; unknown modes and windows raise."""
    args = [torch.from_numpy(a) for a in _variant_case("exact", None, False)]
    tpa.paged_attention.launches = 0
    for variant in approx.VARIANTS:
        out = tops.paged_attention(*args, attn_approx=variant)
        assert torch.isfinite(out).all()
        with pytest.raises(ValueError, match="CUDA tensor"):
            tpa.paged_attention(*args, attn_approx=variant)
    assert tpa.paged_attention.launches == 0
    with pytest.raises(ValueError, match="base2"):
        tops.paged_attention(*args, attn_approx="nope")
    with pytest.raises(ValueError):
        tops.paged_attention(*args, window=0)
    torch.testing.assert_close(tops.paged_attention(*args, attn_approx=None),
                               tops.paged_attention(*args), rtol=0, atol=0)
