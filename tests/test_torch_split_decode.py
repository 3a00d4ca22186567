"""The split-KV decode of the CUDA paged-attention kernel, modelled on the
CPU: ``repro_torch.kernels.ref.paged_attention_split`` (per-chunk
partials from the plain weights, merged in chunk order; base2 and pwl
weigh every chunk at the row's max) against the JAX package's
``repro.kernels.ref.paged_attention`` and its Pallas kernel in interpret
mode, on the same seeded numpy inputs; and the wrapper's chunk planner,
``paged_attention.plan_split`` / ``split_for``, whose chunk width is
fixed per (dtype, head dim) in every score mode.

Operands sit on quarter steps in [-4, 4] and hd is 16 (scale 1/4, a
power of two), so every score is exact in any summation order and both
frameworks form the same f32 scores: ``maxonly`` must then pick the same
key exactly, and ``exact`` / ``pseudo`` differ by summation order only
(1e-5); so do ``base2`` and ``pwl`` from the JAX plain version, which
weighs at the row's max too (``REF_TOL`` of ``test_torch_attn_approx``),
while the Pallas kernel weighs them at a 16-position block's running max
and agrees to one LUT bin or chord (2e-3, its ``TOL`` there).  On the
card, ``tests/test_torch_cuda.py`` holds the kernel itself against the
plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.serve.paged_kv import pow2  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5          # every mode against the plain versions, f32:
                    # summation order only
LUT_TOL = 2e-3      # base2 and pwl against the Pallas kernel: a LUT bin
CHUNK = 64
BS, HKV, G, HD = 16, 2, 2, 16
# each row's last query position: contexts of 1 to 300 keys, at and
# around the 64-key chunk edges
LAST = np.array([0, 62, 63, 64, 128, 191, 299])


def _quarter(rng, *shape):
    return np.clip(np.round(rng.normal(size=shape) * 4), -16, 16
                   ).astype(np.float32) / 4


def _case(seed, t, last=LAST):
    """Ragged rows, permuted pool blocks, tables padded to a power of two
    with a foreign block (past each row's position, never visible)."""
    rng = np.random.default_rng(seed)
    b = len(last)
    nbs = last // BS + 1
    nb = pow2(int(nbs.max()))
    nblocks = int(nbs.sum()) + 2
    perm = rng.permutation(nblocks)
    table, k0 = np.empty((b, nb), np.int32), 0
    for r, n in enumerate(nbs):
        table[r, :n] = perm[k0:k0 + n]
        table[r, n:] = perm[(k0 + n) % nblocks]
        k0 += n
    if t == 1:
        pos = last.astype(np.int32)
    else:
        pos = np.maximum(last[:, None] - np.arange(t - 1, -1, -1), 0
                         ).astype(np.int32)
    qshape = (b, G * HKV, HD) if t == 1 else (b, t, G * HKV, HD)
    return (_quarter(rng, *qshape), _quarter(rng, nblocks, BS, HKV, HD),
            _quarter(rng, nblocks, BS, HKV, HD), table, pos)


def _jax(args, mode, window):
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jops.paged_attention(
        *jargs, use_pallas=True, interpret=True, attn_approx=mode,
        window=window))
    plain = np.asarray(jref.paged_attention(*jargs, attn_approx=mode,
                                            window=window))
    return pallas, plain


def _split(args, mode, window, chunk=CHUNK):
    return tref.paged_attention_split(
        *(torch.from_numpy(a) for a in args), chunk_keys=chunk,
        attn_approx=mode, window=window).numpy()


MODES = ["exact", "base2", "pseudo", "pwl", "maxonly"]


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("window", [None, 5, 100])
@pytest.mark.parametrize("mode", MODES)
def test_split_model_matches_jax_ref_and_pallas(mode, window, t):
    """Contexts of 1-300 keys in 64-key chunks; window 5 leaves most of a
    long row's chunks with no visible key, window 100 a chunk or two."""
    args = _case(10 * t + (window or 0), t)
    got = _split(args, mode, window)
    pallas, plain = _jax(args, mode, window)
    assert got.shape == args[0].shape and got.dtype == np.float32
    if mode == "maxonly":
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, plain)
    else:
        tol = LUT_TOL if mode in ("base2", "pwl") else TOL
        np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
        np.testing.assert_allclose(got, plain, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("chunk", [64, 128, 320])
@pytest.mark.parametrize("mode", MODES)
def test_split_model_matches_the_unsplit_plain_version(mode, chunk):
    """Any chunk width gives the port's unsplit plain version (the CPU
    path), exactly for maxonly; 320 keys is one chunk."""
    args = _case(chunk, 1)
    want = tops.paged_attention(*(torch.from_numpy(a) for a in args),
                                attn_approx=mode).numpy()
    got = _split(args, mode, None, chunk)
    if mode == "maxonly":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("edge", [64, 128, 256])
def test_split_model_maxonly_tie_across_a_chunk_edge_goes_early(edge):
    """Each (row, kv head) has its best key copied to both sides of a
    chunk edge (positions edge - 1 and edge), so the two score exactly
    alike in different chunks; the earlier position's V row must win,
    in the model, the JAX plain version and the Pallas kernel alike."""
    last = np.array([edge + 5, 299])
    q, kp, vp, bt, pos = _case(edge, 1, last=last)
    want = np.empty_like(q)
    for r in range(len(last)):
        for h in range(HKV):
            q[r, h * G:(h + 1) * G] = q[r, h * G]   # one best key per group
            # 4 * sign(q): the highest score any K row on the grid can get
            best = 4.0 * np.sign(q[r, h * G] + 0.125).astype(np.float32)
            for p in (edge - 1, edge):
                blk, off = bt[r, p // BS], p % BS
                kp[blk, off, h] = best
                vp[blk, off, h] = float(p)
            want[r, h * G:(h + 1) * G] = float(edge - 1)
    args = (q, kp, vp, bt, pos)
    got = _split(args, "maxonly", None)
    np.testing.assert_array_equal(got, want)
    pallas, plain = _jax(args, "maxonly", None)
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(plain, want)


def test_split_model_refuses_an_unknown_mode():
    args = [torch.from_numpy(a) for a in _case(0, 1)]
    with pytest.raises(ValueError, match="attn_approx"):
        tref.paged_attention_split(*args, chunk_keys=CHUNK,
                                   attn_approx="nope")


# ---------------------------------------------------------------------------
# The wrapper's chunk planner: a fixed width per (dtype, head dim)
# ---------------------------------------------------------------------------
KEYS = (1, 16, 63, 64, 65, 1000, 1024, 4096, 32768)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_split_covers_the_table_in_whole_stages(dtype, hd):
    """At every table width: whole stages per chunk, chunks covering the
    table with none wholly past it, and the width ``chunk_width(dtype,
    hd)`` whatever the table (so chunk edges are multiples of it in
    absolute position)."""
    assert hd in tpa._HEAD_DIMS
    width = tpa.chunk_width(dtype, hd)
    assert width % tpa.CHUNK_QUANTUM == 0 and width >= 64
    for keys in KEYS:
        n, ck = tpa.plan_split(keys, dtype, hd)
        assert type(n) is int and type(ck) is int
        assert n >= 1 and ck == width, keys
        assert n * ck >= keys > (n - 1) * ck     # no chunk wholly past


def test_plan_split_at_the_served_shapes():
    """qwen3-0.6b decode (hd 128, bf16): 64-position chunks in every score
    mode, so a 1,024-position table takes 16 and a 64-position one 1 --
    the same width whatever the batch; hd 192 (nemotron-4-340b) also 64."""
    bf = torch.bfloat16
    assert tpa.plan_split(1024, bf, 128) == (16, 64)
    assert tpa.plan_split(64, bf, 128) == (1, 64)
    assert tpa.plan_split(1000, bf, 128) == (16, 64)
    assert tpa.plan_split(1024, torch.float32, 192) == (16, 64)
    assert tpa.plan_split(100, bf, 128) == (2, 64)
    assert tpa.chunk_width(bf, 16) == 512 and tpa.chunk_width(bf, 64) == 128


def test_split_for_reads_shapes_not_data():
    """``split_for`` on meta tensors (shapes, no storage): it reads no
    tensor, so it never syncs the host with the card, and its chunk width
    is the same for every B, T, query-group count and table width."""
    kp = torch.empty((100, 16, 8, 128), device="meta", dtype=torch.bfloat16)
    for b in (1, 8, 256):
        for t, hq in ((None, 16), (32, 16), (4, 64)):
            shape = (b, hq, 128) if t is None else (b, t, hq, 128)
            q = torch.empty(shape, device="meta", dtype=torch.bfloat16)
            for nb in (1, 4, 64, 256):
                bt = torch.empty((b, nb), device="meta", dtype=torch.int32)
                assert tpa.split_for(q, kp, bt) == (-(-nb * 16 // 64), 64)
    q = torch.empty((8, 16, 128), device="meta", dtype=torch.bfloat16)
    bt = torch.empty((8, 64), device="meta", dtype=torch.int32)
    assert tpa.split_for(q, kp, bt) == (16, 64)


@pytest.mark.parametrize("last", [0, 63, 64, 200, 500])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_split_model_row_alone_equals_row_beside_a_long_row(mode, t, last):
    """At the wrapper's fixed chunk width a row's chunks are the same
    positions whatever its batch-mates: the row alone (B 1, its own
    table width) and the same row beside a 1,000-token row (B 2, a
    1,024-position table and so more chunks, the rest of them empty for
    it) agree within 1e-6 in f32, maxonly exactly."""
    chunk = tpa.chunk_width(torch.float32, HD)
    pair = np.array([last, 999])
    q, kp, vp, bt, pos = _case(last + t, t, last=pair)
    nb_own = pow2(last // BS + 1)
    alone = (q[:1], kp, vp, np.ascontiguousarray(bt[:1, :nb_own]), pos[:1])
    beside = (q, kp, vp, bt, pos)
    assert bt.shape[1] * BS > nb_own * BS            # more chunks beside
    got_alone = _split(alone, mode, None, chunk)
    got_beside = _split(beside, mode, None, chunk)[:1]
    if mode == "maxonly":
        np.testing.assert_array_equal(got_alone, got_beside)
    else:
        np.testing.assert_allclose(got_alone, got_beside, atol=1e-6,
                                   rtol=1e-6)
