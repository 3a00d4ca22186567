"""The port's CUDA kernels against their plain PyTorch versions, on the
card, across the shapes and dtypes the wrappers take -- beyond the main
path's shapes that ``chip_smoke.py`` checks.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 kernels sum in another order than the plain versions
(atol = rtol = 1e-4), paged attention's pwl too, since the kernel weighs
it at the row's max as the plain version does; base2 likewise, but a
score whose LUT bin edge lies within that rounding takes the
neighbouring bin (2^(1/256) apart) in one of the two, so it keeps 2e-3
in f32 (``_tol``); bf16
paged attention keeps f32 probabilities where the plain version rounds
scores and probabilities to bf16 (2e-2); the exp-free modes where the
scores are exact agree to summation order (1e-5 in f32, one bf16 step
of the output in bf16 against the plain version on f32 inputs), and
bf16 flash attention rounds the same f32 result to bf16 (2e-2, a step
of bf16 at magnitude 2-4); the softmax unit's kernels sum in a split
order (stats and probabilities rtol 2e-5, atol 1e-7; the cross-entropy
rtol 2e-5, atol 1e-6; its gradient rtol 2e-5, atol 1e-7); head
indices must be equal wherever the plain top-2 f32 logit gap exceeds
1e-3 * |max|, and exactly equal on planted ties.  The top-k head's
values agree at rtol 1e-5 (f32) / 1e-3 (bf16); its indices are exact
except where two neighbouring values lie within that rtol, and exact on
integer-valued inputs, whose sums are exact in any order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.softmax_variants import base2_frac_lut  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_argmax_head as fah  # noqa: E402
from repro_torch.kernels import fused_topk_head as ftk  # noqa: E402
from repro_torch.kernels import fused_xent as fx  # noqa: E402
from repro_torch.kernels import online_softmax as osm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.serve.paged_kv import pow2  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged(dev, dtype, *, b, t, hq, hkv, hd, bs, seed, last=None):
    rng = np.random.default_rng(seed)
    last = rng.integers(0, 300, size=b) if last is None else np.asarray(last)
    nbs = last // bs + 1
    nb = pow2(int(nbs.max()))
    nblocks = int(nbs.sum()) + 4
    perm = rng.permutation(nblocks)
    table, k0 = np.empty((b, nb), np.int32), 0
    for r, n in enumerate(nbs):
        table[r, :n] = perm[k0:k0 + n]
        # padded columns point at a FOREIGN block: the mask must drop them
        table[r, n:] = perm[(k0 + n) % nblocks]
        k0 += n
    pos = last if t == 1 else np.maximum(
        last[:, None] - np.arange(t - 1, -1, -1), 0)
    shape = (b, hq, hd) if t == 1 else (b, t, hq, hd)

    def rand(*s):
        return torch.from_numpy(rng.standard_normal(s, np.float32)).to(
            dev, dtype)

    return (rand(*shape), rand(nblocks, bs, hkv, hd),
            rand(nblocks, bs, hkv, hd), torch.from_numpy(table).to(dev),
            torch.from_numpy(pos.astype(np.int32)).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("t,hq,hkv", [(1, 16, 8), (3, 8, 2), (1, 4, 4),
                                      (8, 8, 2), (32, 16, 8), (9, 64, 8)])
@pytest.mark.parametrize("window", [None, 7])
def test_paged_attention_kernel_matches_plain(dev, dtype, hd, t, hq, hkv,
                                              window):
    bs = 8 if hd == 256 else 16
    q, kp, vp, bt, pos = _paged(dev, dtype, b=5, t=t, hq=hq, hkv=hkv, hd=hd,
                                bs=bs, seed=hd + t, last=[0, 5, 130, 299, 64])
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, bt, pos, window=window)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = ref.paged_attention(q, kp, vp, bt, pos, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


def _scores(q, kp, bt, pos, window):
    """f32 scores (b, t, hq, s) of a paged-attention call, -inf where the
    key is not visible."""
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, t = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    k = kp.float()[bt.long()].reshape(b, -1, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    s = torch.einsum("bthd,bshd->bths", q.float().reshape(b, t, hq, hd),
                     k) / hd ** 0.5
    p = pos.reshape(b, t).long()
    kv = torch.arange(k.shape[1], device=q.device)
    vis = kv[None, None, :] <= p[:, :, None]
    if window is not None:
        vis &= kv[None, None, :] > p[:, :, None] - window
    return torch.where(vis[:, :, None, :], s, -torch.inf)


def _maxonly_ok(out, q, kp, vp, bt, pos, window, band=1e-3):
    """Each output row is the V row of a visible key whose f32 score is
    within ``band`` * |best| of the best (the plain version's pick, or a
    near-tie the kernel's summation order decided otherwise)."""
    b, hq, hd = q.shape[0], q.shape[-2], q.shape[-1]
    hkv, t = kp.shape[2], (q.shape[1] if q.dim() == 4 else 1)
    v = vp.float()[bt.long()].reshape(b, -1, hkv, hd).repeat_interleave(
        hq // hkv, dim=2)
    s = _scores(q, kp, bt, pos, window)
    best = s.amax(-1, keepdim=True)
    near = s >= best - band * best.abs()
    got = out.float().reshape(b, t, hq, hd)
    is_row = (got[:, :, :, None] == v.permute(0, 2, 1, 3)[:, None]).all(-1)
    return bool((is_row & near).any(-1).all())


def _tol(dtype, mode):
    """Paged attention against its plain version (the module's header)."""
    if dtype == torch.bfloat16:
        return 2e-2
    return 2e-3 if mode == "base2" else 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("t,hq,hkv", [(1, 16, 8), (3, 8, 2), (9, 64, 8)])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("mode", ["base2", "pseudo", "pwl", "maxonly"])
def test_paged_attention_kernel_modes_match_plain(dev, mode, dtype, hd, t,
                                                  hq, hkv, window):
    """The four exp-free score modes.  base2, pseudo and pwl weigh at the
    row's max, as the plain version does: ``_tol``.  maxonly returns a V
    row, checked by ``_maxonly_ok``."""
    bs = 8 if hd == 256 else 16
    q, kp, vp, bt, pos = _paged(dev, dtype, b=5, t=t, hq=hq, hkv=hkv, hd=hd,
                                bs=bs, seed=hd + t, last=[0, 5, 130, 299, 64])
    before = pa.paged_attention.launches_by_mode[mode]
    out = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode,
                             window=window)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches_by_mode[mode] == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    if mode == "maxonly":
        assert _maxonly_ok(out, q, kp, vp, bt, pos, window)
        return
    want = ref.paged_attention(q, kp, vp, bt, pos, attn_approx=mode,
                               window=window)
    tol = _tol(dtype, mode)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


def test_paged_attention_kernel_maxonly_ties_take_the_earliest_key(dev):
    """Each (row, kv head) gets a key far above the rest (q itself, score
    |q|^2 / sqrt(hd) ~ 8 against ~N(0, 1)), copied to earlier positions
    -- within one 32-key slice, across slices and across 64-key stages --
    so the copies score exactly alike; maxonly must return the V row of
    the earliest copy (V rows differ by the position, so the pick
    shows)."""
    q, kp, vp, bt, pos = _paged(dev, torch.float32, b=2, t=1, hq=2, hkv=2,
                                hd=64, bs=16, seed=3, last=[200, 90])
    want = torch.empty_like(q)
    for r, (src, dsts) in enumerate(((150, (100, 40, 20, 3)),
                                     (80, (70, 11, 10)))):
        for h in range(2):
            for d in (src,) + dsts:
                blk, off = int(bt[r, d // 16]), d % 16
                kp[blk, off, h] = q[r, h]
                vp[blk, off, h] = float(d)
            want[r, h] = float(min(dsts))
    out = pa.paged_attention(q, kp, vp, bt, pos, attn_approx="maxonly")
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=0, rtol=0)


PIN_TOL = 1e-5      # f32 paged modes where kernel and plain share the max


def _pinned(dev, *, t, hq, hkv, hd, window, seed):
    """``_paged`` in f32 on quarter steps in [-4, 4] (every dot product
    exact in any order, so kernel and plain version form the same f32
    scores) with each query's first visible key its strict best: q[..., 0]
    = beta and that key's K row (20 - rank) * e_0, rank 0 for the row's
    earliest such key, a score near 7 against ~N(0, 1.1) for the rest.
    The kernel's running max then never moves after the first slice with
    a visible key, so it evaluates the score function at the plain
    version's max."""
    bs = 8 if hd == 256 else 16
    q, kp, vp, bt, pos = _paged(dev, torch.float32, b=5, t=t, hq=hq,
                                hkv=hkv, hd=hd, bs=bs, seed=seed,
                                last=[0, 5, 130, 299, 64])
    for x in (q, kp, vp):
        x.copy_(torch.clamp(torch.round(x * 4), -16, 16) / 4)
    q[..., 0] = round(0.35 * hd ** 0.5 * 4) / 4
    pos2, table = pos.reshape(5, -1).cpu().numpy(), bt.cpu().numpy()
    for r in range(5):
        first = pos2[r] * 0 if window is None else np.maximum(
            pos2[r] - window + 1, 0)
        for rank, p in enumerate(sorted(set(first.tolist()))):
            blk, off = int(table[r, p // bs]), p % bs
            kp[blk, off] = 0.0
            kp[blk, off, :, 0] = 20.0 - rank
    s = _scores(q, kp, bt, pos, window)
    first = (s > -torch.inf).float().argmax(-1, keepdim=True)
    rest = torch.where(torch.arange(s.shape[-1], device=dev) == first,
                       -torch.inf, s).amax(-1, keepdim=True)
    assert bool((s.gather(-1, first) > rest + 0.25).all())
    return q, kp, vp, bt, pos


@pytest.mark.parametrize("hd", [16, 64, 128, 192, 256])
@pytest.mark.parametrize("t,hq,hkv", [(1, 16, 8), (3, 8, 2)])
@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("mode", ["base2", "pseudo", "pwl"])
def test_paged_attention_kernel_modes_at_a_pinned_max(dev, mode, hd, t, hq,
                                                      hkv, window):
    """Where kernel and plain version evaluate the score function at the
    same max (``_pinned``), the weights are the same floats: f32 outputs
    agree to summation order (PIN_TOL), the kernel's gap to its own exact
    output is within a quarter of the plain version's gap to exact, which
    is 3e-5 or more at these windows (a kernel that ignored the mode
    would miss by the whole gap; summation order, by ~1e-6), and bf16
    copies of the same values come out within one bf16 step of the plain
    version on the f32 inputs."""
    q, kp, vp, bt, pos = _pinned(dev, t=t, hq=hq, hkv=hkv, hd=hd,
                                 window=window, seed=hd + t)

    def both(m, *x):
        return (pa.paged_attention(*x, bt, pos, attn_approx=m, window=window),
                ref.paged_attention(q, kp, vp, bt, pos, attn_approx=m,
                                    window=window))

    out, want = both(mode, q, kp, vp)
    out_ex, want_ex = both("exact", q, kp, vp)
    torch.testing.assert_close(out, want, atol=PIN_TOL, rtol=PIN_TOL)
    gap = (want - want_ex).abs().max().item()
    miss = ((out - out_ex) - (want - want_ex)).abs().max().item()
    assert miss <= 0.25 * gap, (miss, gap)
    out_bf, _ = both(mode, *(x.bfloat16() for x in (q, kp, vp)))
    torch.testing.assert_close(out_bf.float(), want, atol=PIN_TOL,
                               rtol=2.0 ** -8)


def _half_bin_keys(hd, count=8):
    """(n, j, k0): f32 values k0 whose score s = k0 / sqrt(hd) (divided
    or multiplied by the reciprocal, both in f32) gives y = s * log2 e
    exactly n + (j + 0.5) / 256, midway between base2 LUT bins j (even)
    and j + 1."""
    def steps(x, n):
        up = dn = np.float32(x)
        out = [up]
        for _ in range(n):
            up = np.nextafter(up, np.float32(np.inf))
            dn = np.nextafter(dn, np.float32(-np.inf))
            out += [up, dn]
        return out

    c, r = np.float32(1 / np.sqrt(hd)), np.float32(np.sqrt(hd))
    log2e = np.float32(1.4426950408889634)
    out = []
    for n in (-1, -2):
        for j in range(0, 256, 14):
            y = np.float32(n + (j + 0.5) / 256)
            for s in steps(y / log2e, 16):
                if np.float32(s * log2e) != y:
                    continue
                ks = [k for k in steps(s * r, 16)
                      if np.float32(k * c) == s and np.float32(k / r) == s]
                if ks:
                    out.append((n, j, ks[0]))
                    break
            if len(out) == count:
                return out
    raise AssertionError(f"found {len(out)} half-bin keys at hd {hd}")


@pytest.mark.parametrize("hd", [16, 128])
def test_paged_attention_kernel_base2_rounds_half_to_even(dev, hd):
    """Keys whose scores land exactly midway between two base2 LUT bins
    (behind a best key at score 0, so d is the score itself): the kernel
    reads the even bin, as the plain version's round half to even does;
    rounding half away from zero would move each weight by 2^(1/256) and
    the output by far more than PIN_TOL."""
    keys = _half_bin_keys(hd)
    n_keys = len(keys) + 1
    kp = torch.zeros(1, 16, 1, hd, device=dev)
    kp[0, 1:n_keys, 0, 0] = torch.tensor([k for _, _, k in keys])
    vp = torch.from_numpy(np.random.default_rng(hd).standard_normal(
        (1, 16, 1, hd), np.float32)).to(dev)
    q = torch.zeros(1, 1, hd, device=dev)
    q[0, 0, 0] = 1.0
    bt = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    pos = torch.tensor([n_keys - 1], dtype=torch.int32, device=dev)
    out = pa.paged_attention(q, kp, vp, bt, pos, attn_approx="base2")
    want = ref.paged_attention(q, kp, vp, bt, pos, attn_approx="base2")
    torch.testing.assert_close(out, want, atol=PIN_TOL, rtol=PIN_TOL)
    lut = base2_frac_lut(8).numpy().astype(np.float64)
    v = vp[0, :n_keys, 0].double().cpu().numpy()

    def expect(shift):
        w = np.array([1.0] + [2.0 ** n * lut[j + shift] for n, j, _ in keys])
        return w @ v / w.sum()

    np.testing.assert_allclose(want[0, 0].double().cpu().numpy(), expect(0),
                               atol=PIN_TOL, rtol=PIN_TOL)
    assert np.abs(expect(1) - expect(0)).max() > 20 * PIN_TOL


def _split_case(dev, dtype, *, t, seed, rows=8, hq=4, hkv=2, hd=64):
    """8 rows over a 4,096-position table (bs 16), split into chunks of
    ``ck`` keys (the wrapper's fixed width): contexts at the chunk edges
    +-1 (ck - 1, ck, ck + 1, the same at 3 ck) and at 4,095 and 4,096.
    Returns the operands and (n_chunks, ck)."""
    n, ck = pa.plan_split(4096, dtype, hd)
    last = [ck - 2, ck - 1, ck, 3 * ck - 2, 3 * ck - 1, 3 * ck, 4094, 4095]
    return _paged(dev, dtype, b=rows, t=t, hq=hq, hkv=hkv, hd=hd, bs=16,
                  seed=seed + t, last=last[:rows]), (n, ck)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("window", [None, 7, 200])
@pytest.mark.parametrize("mode", ["exact", "base2", "pseudo", "pwl",
                                  "maxonly"])
def test_paged_attention_split_at_chunk_edges(dev, mode, window, t, dtype):
    """Split-KV decode over contexts at the chunk edges +-1, up to 4,096
    keys; window 7 leaves all but one chunk of a row empty.  Every mode
    against the plain version at the tolerances above, in the planner's
    chunks; one launch counts once."""
    (q, kp, vp, bt, pos), (n, ck) = _split_case(dev, dtype, t=t,
                                                seed=window or 0)
    assert n > 1 and ck % pa.CHUNK_QUANTUM == 0
    assert pa.split_for(q, kp, bt) == (n, ck)
    before = pa.paged_attention.launches_by_mode[mode]
    out = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode,
                             window=window)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches_by_mode[mode] == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype
    if mode == "maxonly":
        assert _maxonly_ok(out, q, kp, vp, bt, pos, window)
        return
    want = ref.paged_attention(q, kp, vp, bt, pos, attn_approx=mode,
                               window=window)
    tol = _tol(dtype, mode)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


def test_paged_attention_split_maxonly_tie_across_a_chunk_edge(dev):
    """Copies of a far-best key (q itself) at both sides of chunk edges
    and inside chunks: the combine keeps the earlier chunk on a tie, so
    the V row of the earliest copy wins, as in the unsplit kernel."""
    (q, kp, vp, bt, pos), (n, ck) = _split_case(dev, torch.float32, t=1,
                                                seed=11)
    assert n > 1
    want = torch.empty_like(q)
    hkv, g = kp.shape[2], q.shape[1] // kp.shape[2]
    for r in (6, 7):                              # rows of 4,095+ keys
        copies = (3 * ck, 3 * ck - 1, ck, ck - 1) if r == 6 else (
            2 * ck + 5, 2 * ck, ck + 3)
        for h in range(hkv):
            q[r, h * g:(h + 1) * g] = q[r, h * g]
            for d in copies:
                blk, off = int(bt[r, d // 16]), d % 16
                kp[blk, off, h] = q[r, h * g]
                vp[blk, off, h] = float(d)
            want[r, h * g:(h + 1) * g] = float(min(copies))
    out = pa.paged_attention(q, kp, vp, bt, pos, attn_approx="maxonly")
    torch.cuda.synchronize()
    torch.testing.assert_close(out[6:], want[6:], atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["exact", "base2", "pseudo", "pwl",
                                  "maxonly"])
@pytest.mark.parametrize("b", [1, 8])
def test_paged_attention_split_is_bitwise_repeatable(dev, mode, b):
    """Two calls on the same inputs give the same bits: the chunks come
    from the dtype and head dim, and the combine merges them in chunk
    order."""
    q, kp, vp, bt, pos = _paged(dev, torch.bfloat16, b=b, t=1, hq=16,
                                hkv=8, hd=128, bs=16, seed=b,
                                last=[999, 5, 640, 63, 64, 300, 1, 511][:b])
    a = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
    c = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
    torch.cuda.synchronize()
    assert torch.equal(a, c)
    assert pa.split_for(q, kp, bt)[0] > 1


def test_paged_attention_kernel_rejects_bad_operands(dev):
    q, kp, vp, bt, pos = _paged(dev, torch.bfloat16, b=2, t=1, hq=4, hkv=2,
                                hd=64, bs=16, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                           kp, vp, bt, pos)
    with pytest.raises(ValueError, match="dtypes"):
        pa.paged_attention(q.float(), kp, vp, bt, pos)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_attention(q, kp, vp, bt.long(), pos)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_attention(q[..., :48].contiguous(), kp[..., :48].contiguous(),
                           vp[..., :48].contiguous(), bt, pos)
    with pytest.raises(ValueError, match=r"Hkv \| Hq"):
        pa.paged_attention(q[:, :3].contiguous(), kp, vp, bt, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["exact", "base2", "pseudo", "pwl",
                                  "maxonly"])
@pytest.mark.parametrize("last", [0, 63, 64, 200, 640])
def test_paged_attention_row_bits_alone_and_beside_a_long_row(dev, last,
                                                             mode, dtype):
    """A row's output is the same bits alone (B 1, a table of its own
    width, one chunk or a few) and as row 0 of 8 rows beside a
    1,000-token row (a 1,024-position table, 16 chunks): chunk edges are
    fixed positions and empty chunks weigh nothing in the combine."""
    q, kp, vp, bt, pos = _paged(dev, dtype, b=8, t=1, hq=16, hkv=8,
                                hd=128, bs=16, seed=last,
                                last=[last, 999, 5, 300, 64, 511, 1, 700])
    nb_own = pow2(last // 16 + 1)
    alone = pa.paged_attention(q[:1].contiguous(), kp, vp,
                               bt[:1, :nb_own].contiguous(), pos[:1],
                               attn_approx=mode)
    beside = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
    torch.cuda.synchronize()
    assert pa.split_for(q, kp, bt)[0] >= pa.split_for(
        q[:1], kp, bt[:1, :nb_own])[0]
    assert torch.equal(alone, beside[:1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["exact", "base2", "pseudo", "pwl",
                                  "maxonly"])
@pytest.mark.parametrize("hq,hkv", [(16, 8), (40, 8), (96, 8)])
def test_paged_attention_row_bits_at_t1_and_t8(dev, hq, hkv, mode, dtype):
    """A row's T = 1 output equals, bit for bit, every column of the same
    row at T = 8 whose padding queries repeat its position (a greedy row
    inside a speculative step), at g 2, 5 and 12."""
    q, kp, vp, bt, pos = _paged(dev, dtype, b=4, t=1, hq=hq, hkv=hkv,
                                hd=128, bs=16, seed=hq,
                                last=[999, 0, 130, 64])
    one = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
    q8 = q[:, None].expand(4, 8, hq, 128).contiguous()
    pos8 = pos[:, None].expand(4, 8).contiguous()
    eight = pa.paged_attention(q8, kp, vp, bt, pos8, attn_approx=mode)
    torch.cuda.synchronize()
    for t in range(8):
        assert torch.equal(eight[:, t], one), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["exact", "base2", "pseudo", "pwl",
                                  "maxonly"])
def test_paged_attention_spec_window_bits_equal_each_query_alone(dev, mode,
                                                                 dtype):
    """A speculative step's shape: 8 rows at T 8, each a consecutive
    window of its own width whose padding repeats its last position.
    Every (row, column) output equals, bit for bit, that query alone (B 1,
    T 1, a table of its row's own width)."""
    rng = np.random.default_rng(5)
    last = [999, 0, 130, 64, 511, 700, 63, 300]
    q, kp, vp, bt, _ = _paged(dev, dtype, b=8, t=8, hq=16, hkv=8, hd=128,
                              bs=16, seed=5, last=last)
    pos = np.empty((8, 8), np.int32)
    for r, p in enumerate(last):
        win = np.arange(max(0, p - int(rng.integers(0, 8))), p + 1)
        pos[r, :len(win)], pos[r, len(win):] = win, win[-1]
    pos_t = torch.from_numpy(pos).to(dev)
    out = pa.paged_attention(q, kp, vp, bt, pos_t, attn_approx=mode)
    for r in range(8):
        nb = pow2(int(pos[r].max()) // 16 + 1)
        for c in range(8):
            one = pa.paged_attention(q[r:r + 1, c].contiguous(), kp, vp,
                                     bt[r:r + 1, :nb].contiguous(),
                                     pos_t[r:r + 1, c].contiguous(),
                                     attn_approx=mode)
            assert torch.equal(one[0], out[r, c]), (r, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["exact", "base2", "pseudo", "pwl",
                                  "maxonly"])
def test_paged_attention_chunk_window_bits_equal_t1(dev, mode, dtype):
    """A chunked-prefill step's shape: 8 rows at T 64 -- chunk rows of 64
    and of 23 consecutive prompt positions (padding repeats the last),
    decode rows at one position.  Every (row, column) output equals, bit
    for bit, that query alone at T 1 with a table of its row's width."""
    last = [999, 63, 700, 64, 511, 130, 0, 300]
    widths = [64, 64, 23, 1, 64, 1, 1, 40]
    q, kp, vp, bt, _ = _paged(dev, dtype, b=8, t=64, hq=16, hkv=8, hd=128,
                              bs=16, seed=64, last=last)
    pos = np.empty((8, 64), np.int32)
    for r, (p, w) in enumerate(zip(last, widths)):
        win = np.arange(max(0, p - w + 1), p + 1)
        pos[r, :len(win)], pos[r, len(win):] = win, win[-1]
    pos_t = torch.from_numpy(pos).to(dev)
    out = pa.paged_attention(q, kp, vp, bt, pos_t, attn_approx=mode)
    for r in range(8):
        nb = pow2(int(pos[r].max()) // 16 + 1)
        cols = range(64) if r < 2 else (0, 21, 22, 63)
        for c in cols:
            one = pa.paged_attention(q[r:r + 1, c].contiguous(), kp, vp,
                                     bt[r:r + 1, :nb].contiguous(),
                                     pos_t[r:r + 1, c].contiguous(),
                                     attn_approx=mode)
            assert torch.equal(one[0], out[r, c]), (r, c)


@pytest.mark.parametrize("hd", [64, 128, 192])
@pytest.mark.parametrize("t", [1, 32])
def test_paged_attention_route(dev, t, hd):
    """bf16 runs the tensor-core kernel in every mode, f32 the CUDA-core
    one; base2 and pwl run the row-max pre-pass of the same route first,
    the other modes none -- by kernel name, at T 1 and T 32."""
    for dtype in (torch.bfloat16, torch.float32):
        q, kp, vp, bt, pos = _paged(dev, dtype, b=2, t=t, hq=4, hkv=2, hd=hd,
                                    bs=16, seed=t, last=[700, 40])
        want_mma = dtype == torch.bfloat16
        for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
            want_pre = mode in pa.PREMAX_MODES
            names = _kernel_names(lambda: pa.paged_attention(
                q, kp, vp, bt, pos, attn_approx=mode), "paged_attention")
            mma = any("paged_attention_mma_kernel" in n for n in names)
            core = any("paged_attention_kernel" in n for n in names)
            pre_mma = any("paged_rowmax_mma_kernel" in n for n in names)
            pre_core = any("paged_rowmax_kernel" in n for n in names)
            assert (mma, core) == (want_mma, not want_mma), names
            assert (pre_mma, pre_core) == (want_pre and want_mma,
                                           want_pre and not want_mma), names


@pytest.mark.parametrize("t,hq,hkv", [(1, 16, 8), (32, 16, 8), (4, 96, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_head_dim_192(dev, dtype, t, hq, hkv):
    """nemotron-4-340b's head dim in every mode, T 1 and 32 and its g
    12, against the plain version at the tolerances above."""
    q, kp, vp, bt, pos = _paged(dev, dtype, b=3, t=t, hq=hq, hkv=hkv,
                                hd=192, bs=16, seed=t, last=[999, 0, 130])
    for mode in ("exact", "base2", "pseudo", "pwl", "maxonly"):
        out = pa.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
        torch.cuda.synchronize()
        if mode == "maxonly":
            assert _maxonly_ok(out, q, kp, vp, bt, pos, None)
            continue
        want = ref.paged_attention(q, kp, vp, bt, pos, attn_approx=mode)
        tol = _tol(dtype, mode)
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)


def _flash_operands(dev, dtype, *, b, hq, hkv, t, s, hd, seed):
    """q (B, Hq, T, hd), k, v (B, Hkv, S, hd) as the layer passes them:
    transposed views of (B, L, H, hd) tensors."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(length, heads):
        return torch.randn((b, length, heads, hd), generator=gen,
                           device=dev).to(dtype).transpose(1, 2)

    return rand(t, hq), rand(s, hkv), rand(s, hkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("b,hkv,g,t,s", [(2, 2, 1, 37, 37),
                                         (1, 4, 2, 130, 130),
                                         (1, 2, 8, 48, 160),
                                         (1, 1, 2, 160, 48)])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16), (False, 16)])
def test_flash_attention_kernel_matches_plain(dev, dtype, hd, b, hkv, g, t,
                                              s, causal, window):
    """GQA at g 1, 2 and 8, ragged T, T != S both ways (indices from 0 on
    both sides), causal, full and windowed masks; strided operands."""
    q, k, v = _flash_operands(dev, dtype, b=b, hq=hkv * g, hkv=hkv, t=t,
                              s=s, hd=hd, seed=hd + t + g)
    before = fa.flash_attention.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert out.shape == q.shape and out.dtype == q.dtype
    # the output keeps q's layout: the layer's reshape back is free
    assert out.stride() == q.stride()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("t", [1024, 1000])
@pytest.mark.parametrize("g", [1, 2, 8])
def test_flash_attention_kernel_long_prompts(dev, dtype, hd, t, g):
    """T = S = 1,024 and T = 1,000 (not a multiple of the 64-row query
    tile) at g 1, 2 and 8, causal; a second call gives the same bits."""
    q, k, v = _flash_operands(dev, dtype, b=1, hq=g, hkv=1, t=t, s=t, hd=hd,
                              seed=hd + t + g)
    out = fa.flash_attention(q, k, v)
    again = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    want = ref.flash_attention(q, k, v)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s", [(64, 1024), (1024, 1024), (5, 77)])
def test_ops_flash_attention_non_causal_cross(dev, dtype, t, s):
    """``ops.flash_attention(causal=False)`` as the enc-dec family calls
    it -- the encoder (T = S), the cross-attention (T 64 over S 1,024
    source frames, 16 / 16 heads of 64) and a ragged T != S -- against
    its plain version: the kernel once, and its gradient through the
    autograd Function against the plain version's."""
    q, k, v = _flash_operands(dev, dtype, b=2, hq=16, hkv=16, t=t, s=s,
                              hd=64, seed=t + s)
    before = fa.flash_attention.launches
    out = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=False)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    if dtype != torch.float32:
        return
    live = [x.detach().requires_grad_(True) for x in (q, k, v)]
    g = torch.randn(out.shape, device=dev)
    got = torch.autograd.grad(ops.flash_attention(*live, causal=False),
                              live, g)
    plain = torch.autograd.grad(ref.flash_attention(*live, causal=False),
                                live, g)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _kernel_names(fn, seen, attempts=3):
    """Names of the device kernels a profiler saw ``fn`` launch.  ``fn``
    runs once first, so that its kernels' lazy loading happens outside
    the trace (a first launch can go unrecorded).  A trace can also lose
    its first kernel, so each trace launches a small add before ``fn``;
    a trace with no device event whose name holds ``seen`` is the
    profiler's miss, not an answer: ``fn`` is traced again, up to
    ``attempts`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad.add_(1)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if any(seen in n for n in names):
            break
    return names


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 192, 256])
def test_flash_attention_route(dev, hd):
    """bf16 runs the tensor-core kernel at every head dim and f32 the
    CUDA-core one: what the card ran, by kernel name."""
    for dtype, ran, not_ran in (
            (torch.bfloat16, "flash_attention_mma_kernel",
             "flash_attention_kernel"),
            (torch.float32, "flash_attention_kernel",
             "flash_attention_mma_kernel")):
        q, k, v = _flash_operands(dev, dtype, b=1, hq=2, hkv=1, t=64, s=64,
                                  hd=hd, seed=hd)
        names = _kernel_names(lambda: fa.flash_attention(q, k, v),
                              "flash_attention")
        assert any(ran in n for n in names), names
        assert not any(not_ran in n for n in names), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [2, 12])
def test_flash_attention_head_dim_192_prompt(dev, dtype, g):
    """hd 192 at a 512-token prompt, causal, against the plain version."""
    q, k, v = _flash_operands(dev, dtype, b=1, hq=g, hkv=1, t=512, s=512,
                              hd=192, seed=g)
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.flash_attention(
        q, k, v).float(), atol=tol, rtol=tol)


def test_flash_attention_kernel_contiguous_and_empty_rows(dev):
    """Contiguous operands give the strided result; queries that see no
    key (a causal window with T > S + window) give 0."""
    q, k, v = _flash_operands(dev, torch.float32, b=1, hq=4, hkv=2, t=40,
                              s=8, hd=64, seed=0)
    out = fa.flash_attention(q, k, v, window=4)
    dense = fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), window=4)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)
    assert bool((out[:, :, 11:] == 0).all()) and bool(
        (out[:, :, :11] != 0).any())
    torch.testing.assert_close(out, ref.flash_attention(q, k, v, window=4),
                               atol=1e-4, rtol=1e-4)


def test_flash_attention_kernel_rejects_bad_operands(dev):
    q, k, v = _flash_operands(dev, torch.bfloat16, b=1, hq=4, hkv=2, t=8,
                              s=8, hd=64, seed=0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q.cpu(), k, v)
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtypes"):
        fa.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match=r"Hkv \| Hq"):
        fa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                           v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, v, window=0)


def _rows(dev, dtype, b, v, seed, scale=8.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, v), generator=gen, device=dev) * scale).to(dtype)


UNIT_RTOL, UNIT_ATOL, XENT_ATOL = 2e-5, 1e-7, 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 12, 512])
@pytest.mark.parametrize("v", [777, 4097, 151936])
def test_softmax_unit_kernels_match_plain(dev, dtype, b, v):
    """Phase 1 (stats), phase 2 (probabilities) and the cross-entropy
    against their plain versions; one call each, and the stats kernel
    once more where online_softmax takes the two-launch route."""
    x = _rows(dev, dtype, b, v, seed=b * v)
    lab = torch.randint(0, v, (b,), generator=torch.Generator(
        device=dev).manual_seed(v), device=dev)
    route = osm.plan_of(x).route
    n0 = (osm.softmax_stats.launches, osm.online_softmax.launches,
          fx.fused_xent.launches,
          osm.online_softmax.launches_by_route[route])
    m, l = osm.softmax_stats(x)
    p = osm.online_softmax(x)
    loss = fx.fused_xent(x, lab)
    torch.cuda.synchronize()
    assert (osm.softmax_stats.launches - n0[0], osm.online_softmax.launches
            - n0[1], fx.fused_xent.launches - n0[2],
            osm.online_softmax.launches_by_route[route] - n0[3]) == (
                1 + (route == osm.TWO_LAUNCH), 1, 1, 1)
    rm, rl = ref.softmax_stats(x)
    torch.testing.assert_close(m, rm, rtol=UNIT_RTOL, atol=UNIT_ATOL)
    torch.testing.assert_close(l, rl, rtol=UNIT_RTOL, atol=UNIT_ATOL)
    assert p.dtype == torch.float32 and p.shape == (b, v)
    torch.testing.assert_close(p, ref.online_softmax(x), rtol=UNIT_RTOL,
                               atol=UNIT_ATOL)
    torch.testing.assert_close(p.sum(-1), torch.ones(b, device=dev),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(loss, ref.fused_xent(x, lab), rtol=UNIT_RTOL,
                               atol=XENT_ATOL)
    torch.testing.assert_close(loss, ref.fused_xent_split(
        x, lab, osm.plan_of(x)), rtol=UNIT_RTOL, atol=XENT_ATOL)


def test_softmax_unit_kernels_extreme_range_and_int32_labels(dev):
    """-90 and +80 in one row (a carry that is not rescaled over- or
    underflows), unaligned rows (V odd, scalar loads) and int32 labels."""
    x = torch.cat([torch.full((3, 1001), -90.0, device=dev),
                   torch.full((3, 1000), 80.0, device=dev)], dim=1)
    m, l = osm.softmax_stats(x)
    rm, rl = ref.softmax_stats(x)
    torch.testing.assert_close(m, rm, rtol=UNIT_RTOL, atol=UNIT_ATOL)
    torch.testing.assert_close(l, rl, rtol=UNIT_RTOL, atol=UNIT_ATOL)
    lab = torch.tensor([0, 1000, 2000], device=dev, dtype=torch.int32)
    torch.testing.assert_close(fx.fused_xent(x, lab), ref.fused_xent(x, lab),
                               rtol=UNIT_RTOL, atol=XENT_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_xent_backward_on_card(dev, dtype):
    """``ops.softmax_xent`` forward and backward on the card (the xent
    kernel, then the softmax kernel in the backward) against autograd
    through the plain version; the gradient in the logits' dtype."""
    x = _rows(dev, dtype, 12, 151936, seed=5, scale=4.0)
    lab = torch.randint(0, 151936, (12,), device=dev)
    xa = x.clone().requires_grad_(True)
    xb = x.clone().requires_grad_(True)
    n0 = (fx.fused_xent.launches, osm.online_softmax.launches)
    ops.softmax_xent(xa, lab).mean().backward()
    torch.cuda.synchronize()
    assert (fx.fused_xent.launches - n0[0],
            osm.online_softmax.launches - n0[1]) == (1, 1)
    ref.fused_xent(xb, lab).mean().backward()
    assert xa.grad.dtype == dtype
    tol = (UNIT_RTOL, UNIT_ATOL) if dtype == torch.float32 else (1e-2, 1e-7)
    torch.testing.assert_close(xa.grad.float(), xb.grad.float(), rtol=tol[0],
                               atol=tol[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_unit_kernels_70000_rows(dev, dtype):
    """More rows than grid.y holds (65,535): one launch each, against the
    plain versions, the rows past 65,535 included."""
    b, v = 70000, 1000
    # logits of scale 1: the loss m + log l - x[label] cancels to about
    # one f32 ulp of m where the label is the max, which stays under the
    # cross-entropy's atol (1e-6) only while |m| < 8
    x = _rows(dev, dtype, b, v, seed=7, scale=1.0)
    lab = torch.randint(0, v, (b,), generator=torch.Generator(
        device=dev).manual_seed(7), device=dev)
    m, l = osm.softmax_stats(x)
    p = osm.online_softmax(x)
    loss = fx.fused_xent(x, lab)
    torch.cuda.synchronize()
    rm, rl = ref.softmax_stats(x)
    for got, want in ((m, rm), (l, rl), (p, ref.online_softmax(x))):
        torch.testing.assert_close(got, want, rtol=UNIT_RTOL, atol=UNIT_ATOL)
    torch.testing.assert_close(loss, ref.fused_xent(x, lab), rtol=UNIT_RTOL,
                               atol=XENT_ATOL)
    assert bool((p[65535:].sum(-1) - 1).abs().max() <= 1e-5)


def test_softmax_unit_kernels_reject_bad_operands(dev):
    x = _rows(dev, torch.float32, 4, 300, seed=0)
    lab = torch.zeros(4, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        osm.softmax_stats(x.cpu())
    with pytest.raises(ValueError, match="dtype"):
        osm.online_softmax(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        osm.softmax_stats(x.t().contiguous().t())
    with pytest.raises(ValueError, match=r"\(B, V\)"):
        osm.online_softmax(x[0])
    with pytest.raises(ValueError, match="labels"):
        fx.fused_xent(x, lab.float())
    with pytest.raises(ValueError, match="labels"):
        fx.fused_xent(x, lab[:3])
    with pytest.raises(ValueError, match="labels"):
        fx.fused_xent(x, lab.cpu())


UNIT_KERNELS = ("unit_stats_kernel", "unit_xent_kernel",
                "unit_one_pass_kernel", "normalize_kernel")


def _unit_kernels(fn):
    """The softmax unit's device kernels one call of ``fn`` launched, by
    their names in ``UNIT_KERNELS``."""
    return [k for n in _kernel_names(fn, "unit_") for k in UNIT_KERNELS
            if k in n]


def _edge_rows(dev, dtype, v):
    """The most rows of width v that take the one-pass route here."""
    return osm.device_resident_blocks(dev.index or 0, dtype) // -(
        -v // osm.CHUNK)


def _unit_check(x):
    """Both wrappers on x against the plain versions and the split
    model; returns (m, l, p)."""
    m, l = osm.softmax_stats(x)
    p = osm.online_softmax(x)
    torch.cuda.synchronize()
    rm, rl = ref.softmax_stats(x)
    sm, sl = ref.softmax_stats_split(x, osm.plan_of(x))
    for got, want in ((m, rm), (l, rl), (m, sm), (l, sl)):
        torch.testing.assert_close(got, want, rtol=UNIT_RTOL, atol=UNIT_ATOL)
    assert p.dtype == torch.float32 and p.shape == x.shape
    torch.testing.assert_close(p, ref.online_softmax(x), rtol=UNIT_RTOL,
                               atol=UNIT_ATOL)
    torch.testing.assert_close(p.sum(-1), torch.ones(x.shape[0],
                                                     device=x.device),
                               rtol=1e-5, atol=0)
    return m, l, p


def test_unit_geometry_and_occupancy(dev):
    """The built kernels' geometry is the plan's, and the card holds at
    least the stated blocks per SM of the one-pass kernel."""
    assert osm.geometry() == (osm.THREADS, osm.PER_THREAD, osm.CHUNK,
                              osm.MIN_BLOCKS_PER_SM)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in osm.DTYPES:
        assert osm.device_resident_blocks(dev.index or 0, dtype) >= \
            sms * osm.MIN_BLOCKS_PER_SM


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [4097, 151936])
@pytest.mark.parametrize("past", [0, 1])
def test_unit_routes_at_the_boundary_match_plain(dev, dtype, v, past):
    """B at the route boundary (one-pass) and one past it (two-launch):
    both wrappers against the plain versions and ``softmax_stats_split``."""
    b = _edge_rows(dev, dtype, v) + past
    x = _rows(dev, dtype, b, v, seed=b + v)
    assert osm.plan_of(x).route == (osm.TWO_LAUNCH if past else osm.ONE_PASS)
    _unit_check(x)


@pytest.mark.parametrize("dtype,v", [(torch.float16, 151936),
                                     (torch.float16, 777),
                                     (torch.float32, 1001),
                                     (torch.bfloat16, 4095),
                                     (torch.float32, 3),
                                     (torch.bfloat16, 1)])
@pytest.mark.parametrize("b", [1, 12])
def test_unit_f16_odd_and_short_rows(dev, dtype, v, b):
    """f16 rows, odd V (scalar loads) and V below one chunk."""
    _unit_check(_rows(dev, dtype, b, v, seed=v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unit_row_bits_alone_in_b12_and_b64(dev, dtype):
    """A row's m, l and probabilities are the same bits alone (B 1,
    one-pass), in B 12 (one-pass) and in B 64 (two-launch)."""
    v = 151936
    x = _rows(dev, dtype, 64, v, seed=3)
    runs = {}
    for b, route in ((12, osm.ONE_PASS), (64, osm.TWO_LAUNCH)):
        assert osm.plan_of(x[:b]).route == route
        runs[b] = (*osm.softmax_stats(x[:b]), osm.online_softmax(x[:b]))
    for r in range(12):
        assert osm.plan_of(x[r:r + 1]).route == osm.ONE_PASS
        alone = (*osm.softmax_stats(x[r:r + 1]),
                 osm.online_softmax(x[r:r + 1]))
        for b in (12, 64):
            for a, got in zip(alone, runs[b]):
                assert torch.equal(a, got[r:r + 1]), (r, b)


@pytest.mark.parametrize("dtype,b,v,kernels", [
    (torch.float32, 12, 151936, 1), (torch.bfloat16, 512, 151936, 2),
    (torch.float32, 70000, 1000, 2), (torch.float16, 1, 777, 1)])
def test_unit_device_kernels_per_call(dev, dtype, b, v, kernels):
    """softmax_stats and fused_xent are one device kernel at any B;
    online_softmax one on the one-pass route and two on the other."""
    x = _rows(dev, dtype, b, v, seed=1, scale=1.0)
    lab = torch.randint(0, v, (b,), device=dev)
    assert osm.plan_of(x).route == (osm.ONE_PASS if kernels == 1
                                    else osm.TWO_LAUNCH)
    assert _unit_kernels(lambda: osm.softmax_stats(x)) == [
        "unit_stats_kernel"]
    assert len(_unit_kernels(lambda: osm.online_softmax(x))) == kernels
    assert _unit_kernels(lambda: fx.fused_xent(x, lab)) == [
        "unit_xent_kernel"]


def test_unit_tickets_reset_and_streams_keep_their_own(dev):
    """Calls after calls give the same bits (the last block of a row puts
    its ticket back to 0), on the default stream and on a second one,
    which gets a ticket buffer of its own."""
    x = _rows(dev, torch.float32, 40, 151936, seed=9)
    want = osm.softmax_stats(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [osm.softmax_stats(x) for _ in range(3)]
    torch.cuda.current_stream().wait_stream(side)
    got.append(osm.softmax_stats(x))
    torch.cuda.synchronize()
    for m, l in got:
        assert torch.equal(m, want[0]) and torch.equal(l, want[1])
    assert len({key for key in osm._TICKETS if key[0] == (dev.index or 0)}
               ) >= 2


def test_unit_stats_refuses_graph_capture(dev):
    """A captured softmax_stats would share its stream's row tickets with
    the calls beside its replays, so the wrapper refuses the capture."""
    x = _rows(dev, torch.float32, 4, 9001, seed=2)
    osm.softmax_stats(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            osm.softmax_stats(x)


def test_fused_xent_refuses_graph_capture(dev):
    """fused_xent takes the same row tickets as softmax_stats, so it
    refuses a capture too: it raises, and launches nothing."""
    x = _rows(dev, torch.float32, 4, 9001, seed=2)
    lab = torch.tensor([0, 4095, 4096, 9000], device=dev)
    fx.fused_xent(x, lab)
    torch.cuda.synchronize()
    n0 = fx.fused_xent.launches
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(graph):
            fx.fused_xent(x, lab)
    assert fx.fused_xent.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [4097, 9001, 151936])
def test_fused_xent_labels_on_chunk_edges(dev, dtype, v):
    """Labels at 0, 4095 (the first chunk's last element), 4096 (the
    second's first), V - 1 and at the row's max: the kernel takes each
    from the register its thread folded."""
    x = _rows(dev, dtype, 5, v, seed=v)
    lab = torch.tensor([0, 4095, 4096, v - 1, 0], device=dev)
    lab[4] = torch.argmax(x[4].float())
    loss = fx.fused_xent(x, lab)
    torch.cuda.synchronize()
    for want in (ref.fused_xent(x, lab),
                 ref.fused_xent_split(x, lab, osm.plan_of(x))):
        torch.testing.assert_close(loss, want, rtol=UNIT_RTOL,
                                   atol=XENT_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_xent_row_bits_alone_in_b12_b64_and_b4096(dev, dtype):
    """A row's loss is the same bits alone and in B 12, 64 and 4,096."""
    v = 151936
    x = _rows(dev, dtype, 4096, v, seed=4, scale=4.0)
    lab = torch.randint(0, v, (4096,), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)
    runs = {b: fx.fused_xent(x[:b], lab[:b]) for b in (12, 64, 4096)}
    for r in range(12):
        alone = fx.fused_xent(x[r:r + 1], lab[r:r + 1])
        for b, got in runs.items():
            assert torch.equal(alone, got[r:r + 1]), (r, b)


def test_fused_xent_label_outside_the_row_gives_nan(dev):
    """A label outside [0, V) is not read: its row's loss is NaN, and the
    other rows keep theirs."""
    x = _rows(dev, torch.float32, 3, 9001, seed=6)
    lab = torch.tensor([5, 9001, -1], device=dev)
    loss = fx.fused_xent(x, lab)
    torch.cuda.synchronize()
    assert torch.isnan(loss[1:]).all()
    torch.testing.assert_close(loss[:1], ref.fused_xent(x[:1], lab[:1]),
                               rtol=UNIT_RTOL, atol=XENT_ATOL)


def _head_check(h, emb, pairs=()):
    """Kernel vs plain on (h, emb.T).  ``pairs`` are (row, a, j) with
    vocab rows a and j made equal: where the plain argmax picks one of
    them, the kernel (which sums equal rows identically) must return the
    lower."""
    w = emb.t()
    idx, val = fah.fused_argmax_head_with_value(h, w)
    torch.cuda.synchronize()
    ridx, rval = ref.fused_argmax_head_with_value(h, w)
    top2 = torch.matmul(h.float(), w.float()).topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 1e-3 * rval.abs()
    assert bool(((idx == ridx) | ~decided).all())
    rtol = 1e-5 if h.dtype == torch.float32 else 1e-3
    torch.testing.assert_close(val, rval, rtol=rtol, atol=1e-5)
    for r, a, j in pairs:
        if int(ridx[r]) in (a, j):
            assert int(idx[r]) == min(a, j)
    return idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 5, 8, 13, 64])
@pytest.mark.parametrize("d,v", [(64, 1000), (1024, 50000), (96, 777)])
def test_argmax_head_kernel_matches_plain(dev, dtype, b, d, v):
    gen = torch.Generator(device=dev).manual_seed(b * v + d)
    emb = (torch.randn((v, d), generator=gen, device=dev)
           / d ** 0.5).to(dtype)
    h = torch.randn((b, d), generator=gen, device=dev).to(dtype)
    # copy rows 0 and 1's winners half the vocabulary away: exact ties
    # across far splits
    pairs = [(r, a, (a + v // 2) % v)
             for r, a in enumerate(ref.fused_argmax_head(h, emb.t())
                                   .tolist()[:2])]
    for _, a, j in pairs:
        emb[j] = emb[a]
    before = fah.fused_argmax_head_with_value.launches
    _head_check(h, emb, pairs)
    assert fah.fused_argmax_head_with_value.launches == before + 1


def test_argmax_head_kernel_ties_go_to_lowest_index(dev):
    for dtype in (torch.float32, torch.bfloat16):
        emb = torch.full((151936, 64), -1.0, device=dev, dtype=dtype)
        for j in (151935, 70001, 100, 99999):
            emb[j] = 1.0
        h = torch.ones((3, 64), device=dev, dtype=dtype)
        idx = _head_check(h, emb)
        assert idx.tolist() == [100, 100, 100]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8, 65])
def test_argmax_head_kernel_masks_the_vocab_tail(dev, dtype, b):
    """Every logit negative and V = 777, not a multiple of the 128-id
    tile: ids past V must never win with the 0 of a zero-filled W row."""
    gen = torch.Generator(device=dev).manual_seed(b)
    emb = -(torch.rand((777, 40), generator=gen, device=dev) + 0.5).to(dtype)
    h = (torch.rand((b, 40), generator=gen, device=dev) + 0.5).to(dtype)
    idx = _head_check(h, emb)
    assert bool((idx < 777).all())


def test_head_plan_matches_the_kernel_geometry(dev):
    """The wrapper's copy of the tensor-core tile equals the built
    kernel's, and the card's limits are read from the device."""
    assert fah.tile_geometry() == (fah.VOCAB_TILE, fah.K_SLAB,
                                   fah.ROW_GROUP, fah.STAGES,
                                   fah.TILE_SMEM_BYTES)
    sms, smem = fah.device_limits(dev.index or 0)
    props = torch.cuda.get_device_properties(dev)
    assert sms == props.multi_processor_count
    assert fah.TILE_SMEM_BYTES + fah.STATIC_SMEM <= smem


def test_head_row_bits_alone_in_batch_and_in_verify(dev):
    """qwen3-0.6b's width, bf16: each row's (val, idx) from the argmax
    head is the same bits alone (B 1), as row r of B 8 and of B 64, and
    its id the same as position t of the verify head at T 8 and T 32."""
    v, d = 151936, 1024
    gen = torch.Generator(device=dev).manual_seed(17)
    emb = (torch.randn((v, d), generator=gen, device=dev)
           / d ** 0.5).to(torch.bfloat16)
    w = emb.t()
    h = torch.randn((256, d), generator=gen, device=dev).to(torch.bfloat16)
    alone = [fah.fused_argmax_head_with_value(h[r:r + 1].contiguous(), w)
             for r in range(8)]
    b8 = fah.fused_argmax_head_with_value(h[:8].contiguous(), w)
    b64 = fah.fused_argmax_head_with_value(h[:64].contiguous(), w)
    ids8, _ = fah.fused_verify_head(
        h[:64].reshape(8, 8, d).contiguous(), w,
        torch.full((8, 7), -1, dtype=torch.int32, device=dev))
    ids32, _ = fah.fused_verify_head(
        h.reshape(8, 32, d).contiguous(), w,
        torch.full((8, 31), -1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    for r, (i1, v1) in enumerate(alone):
        assert torch.equal(i1[0], b8[0][r]) and torch.equal(v1[0], b8[1][r])
        assert torch.equal(i1[0], b64[0][r])
        assert torch.equal(v1[0], b64[1][r])
        assert int(ids8.view(-1)[r]) == int(i1[0])
        assert int(ids32.view(-1)[r]) == int(i1[0])
    # every row of the B 64 call as the verify head's positions
    assert torch.equal(ids8.view(-1), b64[0])
    assert torch.equal(ids32.view(-1)[:64], b64[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_take_d_18432(dev, dtype):
    """nemotron-4-340b's d_model at a small vocabulary: the argmax head at
    B 1 and 8, the verify head at B 8, T 8 and the top-k head at B 8, k 8
    against their plain versions (bf16 streams D in slabs; f32 and top-k
    stage 2 rows per block)."""
    v, d = 3000, 18432
    gen = torch.Generator(device=dev).manual_seed(18)
    emb = (torch.randn((v, d), generator=gen, device=dev)
           / d ** 0.5).to(dtype)
    for b in (1, 8):
        h = torch.randn((b, d), generator=gen, device=dev).to(dtype)
        _head_check(h, emb)
    _topk_check(h, emb, 8)
    hi = torch.randint(-1, 2, (8, 8, d), generator=gen, device=dev).to(dtype)
    ei = torch.randint(-2, 3, (v, d), generator=gen, device=dev).to(dtype)
    cand = torch.full((8, 7), -1, dtype=torch.int32, device=dev)
    rids, _ = ref.verify_draft(hi, ei.t(), cand)
    cand[:, :3] = rids[:, :3]
    ids, acc = fah.fused_verify_head(hi, ei.t(), cand)
    torch.cuda.synchronize()
    rids, racc = ref.verify_draft(hi, ei.t(), cand)
    assert torch.equal(ids, rids) and torch.equal(acc, racc)
    assert bool((acc >= 3).all())


def test_argmax_head_kernel_rejects_bad_operands(dev):
    emb = torch.randn((300, 64), device=dev, dtype=torch.bfloat16)
    h = torch.randn((2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\.T view"):
        fah.fused_argmax_head_with_value(h, emb.t().contiguous())
    with pytest.raises(ValueError, match="dtypes"):
        fah.fused_argmax_head_with_value(h.float(), emb.t())
    with pytest.raises(ValueError, match="multiple"):
        fah.fused_argmax_head_with_value(h[:, :60].contiguous(),
                                         emb[:, :60].contiguous().t())


def _topk_check(h, emb, k):
    """Kernel vs plain top-k on (h, emb.T): values at the dtype's rtol,
    indices equal wherever the neighbouring plain values differ by more
    than that rtol (a near-tie may swap two ids)."""
    w = emb.t()
    vals, idxs = ftk.fused_topk_head(h, w, k)
    torch.cuda.synchronize()
    rvals, ridxs = ref.fused_topk_head(h, w, k)
    assert vals.shape == idxs.shape == (h.shape[0], k)
    assert vals.dtype == torch.float32 and idxs.dtype == torch.int32
    rtol = 1e-5 if h.dtype == torch.float32 else 1e-3
    torch.testing.assert_close(vals, rvals, rtol=rtol, atol=1e-5)
    # an index is decided when its value stands apart from both plain
    # neighbours, the (k+1)-th value included
    full, _ = ref.fused_topk_head(h, w, min(k + 1, w.shape[1]))
    inf = torch.full_like(full[:, :1], float("inf"))
    to_next = full - torch.cat([full[:, 1:], -inf], dim=1)
    to_prev = torch.cat([inf, to_next[:, :-1]], dim=1)
    decided = (torch.minimum(to_next, to_prev)
               > rtol * full.abs())[:, :k]
    assert bool(((idxs == ridxs) | ~decided).all())
    return vals, idxs, rvals, ridxs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 8, 13])
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("d,v", [(64, 1000), (1024, 151936), (96, 777)])
def test_topk_head_kernel_matches_plain(dev, dtype, b, k, d, v):
    gen = torch.Generator(device=dev).manual_seed(b * v + d + k)
    emb = (torch.randn((v, d), generator=gen, device=dev)
           / d ** 0.5).to(dtype)
    h = torch.randn((b, d), generator=gen, device=dev).to(dtype)
    before = ftk.fused_topk_head.launches
    _topk_check(h, emb, k)
    assert ftk.fused_topk_head.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k", [(1, 64), (5, 64), (8, 7)])
def test_topk_head_kernel_exact_on_integer_ties(dev, dtype, b, k):
    """Integer-valued operands: every sum is exact in any order, and
    many logits tie -- across every vocabulary split -- so values and
    indices must equal the plain version's exactly: values descending,
    the lower index first."""
    v, d = 151936, 64
    gen = torch.Generator(device=dev).manual_seed(b + k)
    emb = torch.randint(-2, 3, (v, d), generator=gen, device=dev).to(dtype)
    h = torch.randint(-1, 2, (b, d), generator=gen, device=dev).to(dtype)
    vals, idxs, rvals, ridxs = _topk_check(h, emb, k)
    assert torch.equal(vals, rvals) and torch.equal(idxs, ridxs)
    # ties really were there: some value repeats within the top k
    assert bool((vals[:, 1:] == vals[:, :-1]).any())


@pytest.mark.parametrize("b,k", [(4, 64), (4, 8), (1, 64), (13, 64)])
def test_topk_head_kernel_bitwise_at_qwen_width(dev, b, k):
    """qwen3-0.6b's width (D 1,024, V 151,936), integer-valued bf16
    operands (exact sums): the kernel's values and indices equal
    ``ref.topk_select`` of the logits bit for bit, ties and all; two calls
    give the same bits."""
    v, d = 151936, 1024
    gen = torch.Generator(device=dev).manual_seed(b * k)
    emb = torch.randint(-2, 3, (v, d), generator=gen, device=dev).to(
        torch.bfloat16)
    h = torch.randint(-1, 2, (b, d), generator=gen, device=dev).to(
        torch.bfloat16)
    vals, idxs = ftk.fused_topk_head(h, emb.t(), k)
    again = ftk.fused_topk_head(h, emb.t(), k)
    torch.cuda.synchronize()
    rvals, ridxs = ref.topk_select(torch.matmul(h.float(), emb.float().t()),
                                   k)
    assert torch.equal(vals, rvals) and torch.equal(idxs, ridxs)
    assert torch.equal(vals, again[0]) and torch.equal(idxs, again[1])


def test_topk_head_kernel_small_vocab_and_rejects(dev):
    """V = k (every id survives) and V below a split's width; bad k and
    operands raise."""
    emb = torch.randn((64, 32), device=dev)
    h = torch.randn((2, 32), device=dev)
    _topk_check(h, emb, 64)
    _topk_check(h, emb[:40].contiguous(), 40)
    with pytest.raises(ValueError, match="k="):
        ftk.fused_topk_head(h, emb.t(), 65)
    with pytest.raises(ValueError, match="k="):
        ftk.fused_topk_head(h, emb.t(), 0)
    with pytest.raises(ValueError, match=r"\.T view"):
        ftk.fused_topk_head(h, emb.t().contiguous(), 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t", [(1, 2), (8, 2), (8, 8), (3, 40), (2, 1),
                                 (8, 32)])
def test_verify_head_kernel_matches_plain(dev, dtype, b, t):
    """ids and accept exact against the plain version on integer-valued
    operands (exact sums), with drafts that match a random prefix of
    each row's ids and ragged -1 padding."""
    v, d = 151936, 64
    gen = torch.Generator(device=dev).manual_seed(b * 100 + t)
    emb = torch.randint(-2, 3, (v, d), generator=gen, device=dev).to(dtype)
    h = torch.randint(-1, 2, (b, t, d), generator=gen, device=dev).to(dtype)
    w = emb.t()
    ids0, _ = ref.verify_draft(h, w, torch.full((b, t - 1), -1,
                                                dtype=torch.int32,
                                                device=dev))
    rng = np.random.default_rng(b + t)
    cand = np.full((b, t - 1), -1, np.int32)
    for r in range(b):
        width = int(rng.integers(0, t))           # ragged draft widths
        cand[r, :width] = ids0[r, :width].cpu().numpy()
        if width and rng.random() < 0.5:          # a wrong draft mid-run
            j = int(rng.integers(0, width))
            cand[r, j] = (cand[r, j] + 1) % v
    cand_t = torch.from_numpy(cand).to(dev)
    before = fah.fused_verify_head.launches
    ids, acc = fah.fused_verify_head(h, w, cand_t)
    torch.cuda.synchronize()
    assert fah.fused_verify_head.launches == before + 1
    rids, racc = ref.verify_draft(h, w, cand_t)
    assert torch.equal(ids, rids) and torch.equal(acc, racc)
    assert ids.dtype == acc.dtype == torch.int32


@pytest.mark.parametrize("d", [128, 1024, 5120])
def test_rms_norm_bits_do_not_depend_on_the_row_count(dev, d):
    """The trunk's RMSNorm gives a row the same bits among 1 to 512 rows
    (its mean accumulates in f64): torch.mean's f32 order on the card
    follows the row count, which made a speculative step's rows differ
    from the same rows in a greedy step."""
    from repro_torch.models.layers import rms_norm

    gen = torch.Generator(device=dev).manual_seed(d)
    x = (torch.randn((512, d), generator=gen, device=dev) * 3).bfloat16()
    w = torch.randn(d, generator=gen, device=dev).bfloat16()
    full = rms_norm(x, w)
    for n in (1, 2, 8, 16, 64, 100, 256):
        assert torch.equal(rms_norm(x[:n].contiguous(), w), full[:n]), n
    assert torch.equal(rms_norm(x.reshape(8, 64, d), w).reshape(512, d),
                       full)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-32b"])
def test_engine_on_card_matches_cpu(dev, arch):
    """The smoke config served on the card (kernels) gives the CPU's
    tokens (plain versions) from the same weights, and the decode path
    launches each kernel.  qwen3-32b's head is an untied ``lm_head``."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config(arch))
    cpu = seeded_params(cfg, 3, "cpu")

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, d) for v in tree]
        return tree.to(d)

    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (3, 17, 40, 9, 26)]
    sp = SamplingParams(max_new_tokens=10)
    kw = dict(n_slots=3, max_len=64, block_size=8, num_blocks=12)
    want = LLM(cpu, cfg, **kw).generate(prompts, sp)
    pa.paged_attention.launches = 0
    fah.fused_argmax_head_with_value.launches = 0
    fa.flash_attention.launches = 0
    llm = LLM(to(cpu, dev), cfg, **kw)
    got = llm.generate(prompts, sp)
    st = llm.stats
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert pa.paged_attention.launches == cfg.n_layers * st["decode_steps"]
    assert fa.flash_attention.launches == cfg.n_layers * st["prefills"]
    assert fah.fused_argmax_head_with_value.launches == (
        st["decode_steps"] + st["prefills"])

    # sampled, candidate and speculative requests in one run: the same
    # tokens as the plain versions, through the top-k and verify kernels
    phrase = rng.integers(0, cfg.vocab_size, size=5)
    rep = np.tile(phrase, 6).astype(np.int32)
    mixed = [SamplingParams(max_new_tokens=10, top_k=4, temperature=0.8,
                            seed=1),
             SamplingParams(max_new_tokens=10, n_candidates=4),
             SamplingParams(max_new_tokens=10, head_mode="temperature",
                            seed=2),
             SamplingParams(max_new_tokens=10, spec_k=4),
             SamplingParams(max_new_tokens=10, spec_k=20)]
    prompts = prompts[:3] + [rep, rep[:17]]
    want = LLM(cpu, cfg, **kw).generate(prompts, mixed)
    ftk.fused_topk_head.launches = 0
    fah.fused_verify_head.launches = 0
    llm = LLM(to(cpu, dev), cfg, **kw)
    got = llm.generate(prompts, mixed)
    calls = llm.stats["head_calls"]
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert ftk.fused_topk_head.launches == calls["TopK"] > 0
    assert fah.fused_verify_head.launches == calls["verify"] > 0


# -- the decode step as one CUDA graph (serve/step_graph.py) ----------------


def _graph_engine(dev, dtype, **kw):
    """A smoke-size qwen3-0.6b engine on the card in ``dtype`` (16 slots
    of 4 blocks of 16 unless ``kw`` says otherwise), its pools filled
    with random K/V."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.weights import seeded_params

    cfg = dataclasses.replace(smoke_config(get_config("qwen3-0.6b")),
                              dtype="bfloat16" if dtype == torch.bfloat16
                              else "float32")
    params = seeded_params(cfg, 5, dev)
    eng = ServeEngine(params, cfg, **{"n_slots": 16, "max_len": 64, **kw})
    gen = torch.Generator(device=dev).manual_seed(6)
    for p in eng.store.pools.values():
        p.copy_(torch.randn(p.shape, generator=gen, device=dev))
    return eng


def _step_operands(eng, b, t, seed, half=0):
    """One step's host operands for ``eng``: b rows at t queries, each row
    on 4 blocks of its own from half ``half`` of the pool (no two rows
    write one cell, and operands of the two halves read none of each
    other's); at t = 1 three head groups (Greedy, Temperature, TopK 4),
    at t > 1 a Greedy group and every row in the verify group with
    ragged -1 padded drafts.  Returns (order, arrays)."""
    from repro_torch.serve.paged_kv import pow2
    from repro_torch.serve.sampler import (Greedy, Temperature, TopK,
                                           canonical_order)

    rng = np.random.default_rng(seed)
    nb, bs, v = 4, eng.store.block_size, eng.cfg.vocab_size
    n = eng.store.allocator.num_blocks // 2
    perm = rng.permutation(n) + half * n
    btab = perm[:b * nb].reshape(b, nb).astype(np.int32)
    last = rng.integers(t, nb * bs, size=b)
    posm = (last[:, None] - np.arange(t - 1, -1, -1)).astype(np.int32)
    toks = rng.integers(0, v, size=(b, t)).astype(np.int64)
    order = tuple(canonical_order(
        [Greedy(), Temperature(), TopK(4)] if t == 1 else [Greedy()]))
    rows = [rng.choice(b, size=pow2(max(1, b // (g + 1)))).astype(np.int64)
            for g in range(len(order))]
    arrays = [toks, posm[:, 0].copy() if t == 1 else posm, btab, *rows]
    if t > 1:
        cand = rng.integers(0, v, size=(b, t - 1)).astype(np.int32)
        for r, w in enumerate(rng.integers(0, t, size=b)):
            cand[r, w:] = -1
        arrays += [np.arange(b, dtype=np.int64), cand]
    return order, tuple(arrays)


def _leaves_on_host(out):
    """(h, outputs) of a step body as a flat list of CPU copies."""
    h, outs = out
    flat = [h]
    for o in outs:
        flat += list(o) if isinstance(o, tuple) else [o]
    return [x.cpu().clone() for x in flat]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("t", [1, 8])
def test_captured_step_bitwise_equals_eager(dev, dtype, b, t):
    """A captured step's hidden states and every head group's output
    (Greedy, Temperature, TopK at T 1; Greedy and the verify group at T
    8) are the eager step's bits on the same operands."""
    import functools

    from repro_torch.serve import step_graph

    eng = _graph_engine(dev, dtype)
    order, arrays = _step_operands(eng, b, t, seed=b * 10 + t)
    body = functools.partial(eng._step_body, order)
    want = _leaves_on_host(body(*step_graph.to_device(arrays, dev)))
    eng.graphs.capture("case", body, arrays, dev)
    got = _leaves_on_host(eng.graphs.replay("case", arrays))
    assert len(got) == len(want) == 1 + len(order) + (t > 1) + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert eng.graphs.captures == eng.graphs.replays == 1


def test_one_bucket_replays_over_two_batches(dev):
    """One capture serves every batch of its bucket: replayed over batch
    B (other tokens, positions, block ids and head rows), then batch A
    again, it gives each batch's eager bits."""
    import functools

    from repro_torch.serve import step_graph

    eng = _graph_engine(dev, torch.bfloat16)
    order, a = _step_operands(eng, 8, 1, seed=1)
    order_b, b = _step_operands(eng, 8, 1, seed=2, half=1)
    assert order == order_b and [x.shape for x in a] == [x.shape for x in b]
    body = functools.partial(eng._step_body, order)
    want_a = _leaves_on_host(body(*step_graph.to_device(a, dev)))
    want_b = _leaves_on_host(body(*step_graph.to_device(b, dev)))
    assert not torch.equal(want_a[0], want_b[0])
    eng.graphs.capture("bucket", body, a, dev)
    for arrays, want in ((b, want_b), (a, want_a), (b, want_b)):
        got = _leaves_on_host(eng.graphs.replay("bucket", arrays))
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_capture_beside_a_dead_engine(dev):
    """A captured engine dropped in a reference cycle is freed only by
    the garbage collector; with the collector made to run at every
    allocation, another engine's capture still succeeds (no collection
    inside a capture) and replays the eager bits."""
    import functools
    import gc

    from repro_torch.serve import step_graph

    dead = _graph_engine(dev, torch.bfloat16)
    order, arrays = _step_operands(dead, 8, 1, seed=4)
    body = functools.partial(dead._step_body, order)
    body(*step_graph.to_device(arrays, dev))
    dead.graphs.capture("dead", body, arrays, dev)
    dead.cycle = dead
    del dead, body
    eng = _graph_engine(dev, torch.bfloat16)
    order, arrays = _step_operands(eng, 8, 1, seed=5)
    body = functools.partial(eng._step_body, order)
    want = _leaves_on_host(body(*step_graph.to_device(arrays, dev)))
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        eng.graphs.capture("live", body, arrays, dev)
    finally:
        gc.set_threshold(*threshold)
    gc.collect()
    got = _leaves_on_host(eng.graphs.replay("live", arrays))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_launch_counters_after_replays(dev):
    """A capture counts no launch; N replays count N times the eager
    step's launches, kernel by kernel and paged attention by mode."""
    import functools

    from repro_torch.serve import step_graph

    eng = _graph_engine(dev, torch.bfloat16)
    order, arrays = _step_operands(eng, 8, 8, seed=3)
    body = functools.partial(eng._step_body, order)
    wr = step_graph.kernel_wrappers()
    before = step_graph.read_counts(wr)
    body(*step_graph.to_device(arrays, dev))
    after_eager = step_graph.read_counts(wr)
    eager = step_graph.count_delta(before, after_eager)
    assert eager[("paged_attention", "launches", None)] == eng.cfg.n_layers
    assert eager[("fused_verify_head", "launches", None)] == 1
    eng.graphs.capture("counted", body, arrays, dev)
    assert step_graph.read_counts(wr) == after_eager
    for _ in range(5):
        eng.graphs.replay("counted", arrays)
    torch.cuda.synchronize()
    assert step_graph.count_delta(after_eager, step_graph.read_counts(wr)) \
        == {k: 5 * n for k, n in eager.items()}


def test_graphed_generate_equals_eager(dev):
    """``LLM.generate`` on the card replays captured steps and gives the
    tokens of the same requests served under ``eager_steps()``."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve import step_graph
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config("qwen3-0.6b"))
    params = seeded_params(cfg, 8, dev)
    rng = np.random.default_rng(8)
    rep = np.tile(rng.integers(0, cfg.vocab_size, size=5), 6)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (3, 19, 33)]
    prompts += [rep, rep[:17]]
    sp = [SamplingParams(max_new_tokens=12),
          SamplingParams(max_new_tokens=12, top_k=4, seed=1),
          SamplingParams(max_new_tokens=12, head_mode="temperature", seed=2),
          SamplingParams(max_new_tokens=12, spec_k=4),
          SamplingParams(max_new_tokens=12, n_candidates=3)]
    kw = dict(n_slots=4, max_len=96)
    with step_graph.eager_steps():
        eager = LLM(params, cfg, **kw)
        want = eager.generate(prompts, sp)
    assert len(eager.engine.graphs) == 0
    llm = LLM(params, cfg, **kw)
    got = llm.generate(prompts, sp)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    g = llm.engine.graphs
    assert g.captures == len(g) > 0 and g.replays > 0
    # each bucket's first step runs eagerly, its second captures and
    # replays, the rest replay
    assert set(g.graphs) <= g.seen
    assert len(g.seen) + g.replays == llm.stats["decode_steps"]
    assert g.pool_bytes() > 0


@pytest.mark.parametrize("head", ["Temperature", "SoftmaxBaseline"])
def test_logit_heads_copy_no_f32_weight(dev, head):
    """At qwen3-0.6b's width and B 8 the Temperature and softmax-baseline
    heads read the bf16 head weight in place: under 64 MB allocated
    beyond their inputs (a (D, V) f32 copy of W is 622 MB), with logits
    within rtol 1e-5 (plus 1e-5 of the largest |logit|) of the f32
    product."""
    from repro_torch.configs import get_config
    from repro_torch.serve import sampler

    cfg = get_config("qwen3-0.6b")
    gen = torch.Generator(device=dev).manual_seed(9)
    params = {"embed": torch.randn(cfg.vocab_size, cfg.d_model,
                                   generator=gen, device=dev).to(
        torch.bfloat16)}
    h = torch.randn(8, cfg.d_model, generator=gen, device=dev).to(
        torch.bfloat16)
    s = getattr(sampler, head)()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = s.head(params, cfg, h)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 64 << 20
    want = torch.matmul(h.float(), params["embed"].t().float())
    if head == "Temperature":
        torch.testing.assert_close(out, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    else:
        top2 = want.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 1e-3 * top2[:, 0].abs()
        assert bool(((out == want.argmax(-1)) | ~decided).all())


# -- chunked prefill and prefix sharing on the card -------------------------


def test_chunked_generate_graphed_equals_eager(dev):
    """A chunked engine (chunk 8, token budget 20, prefix sharing on)
    serving greedy, top-k, speculative and shared-prefix requests gives
    the same tokens graphed and under ``eager_steps()``, replays chunk
    steps, and launches paged attention once a layer a step and no flash
    kernel."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve import step_graph
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config("qwen3-0.6b"))
    params = seeded_params(cfg, 10, dev)
    rng = np.random.default_rng(10)
    shared = rng.integers(0, cfg.vocab_size, size=24)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, 5)])
               for _ in range(3)]
    prompts += [rng.integers(0, cfg.vocab_size, size=n) for n in (3, 41)]
    prompts.append(np.tile(rng.integers(0, cfg.vocab_size, size=5), 6))
    sp = [SamplingParams(max_new_tokens=10)] * 4 + [
        SamplingParams(max_new_tokens=10, top_k=4, seed=3),
        SamplingParams(max_new_tokens=10, spec_k=4)]
    kw = dict(n_slots=2, max_len=96, block_size=4, chunk_size=8,
              token_budget=20)
    with step_graph.eager_steps():
        eager = LLM(params, cfg, **kw)
        want = eager.generate(prompts, sp)
    assert len(eager.engine.graphs) == 0
    llm = LLM(params, cfg, **kw)
    n_pa, n_fa = pa.paged_attention.launches, fa.flash_attention.launches
    got = llm.generate(prompts, sp)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    st, g = llm.stats, llm.engine.graphs
    assert st["prefill_chunks"] > len(prompts) and st["prefix_hits"] > 0
    assert g.replays > 0 and len(g.seen) + g.replays == st["decode_steps"]
    assert pa.paged_attention.launches - n_pa \
        == cfg.n_layers * st["decode_steps"]
    assert fa.flash_attention.launches == n_fa


def test_chunk_bucket_replay_bitwise_equals_eager(dev):
    """A step of two decode rows, a mid-prefill chunk row and a final
    chunk row at T 64 (bf16): the replay of its bucket's graph gives the
    eager body's hidden states and head outputs bit for bit."""
    import functools

    from repro_torch.serve import step_graph
    from repro_torch.serve.engine import Request
    from repro_torch.serve.params import SamplingParams

    eng = _graph_engine(dev, torch.bfloat16, n_slots=4, max_len=256,
                        chunk_size=64)
    rng = np.random.default_rng(11)
    v = eng.cfg.vocab_size
    for rid, n in enumerate((5, 7)):
        eng.submit(Request(rid, rng.integers(0, v, n).astype(np.int32),
                           params=SamplingParams(max_new_tokens=8)))
    with step_graph.eager_steps():
        eng.step()                       # both prompts in one final chunk
    for rid, n in ((2, 150), (3, 40)):
        eng.submit(Request(rid, rng.integers(0, v, n).astype(np.int32),
                           params=SamplingParams(max_new_tokens=8)))
    eng._admit()                         # both packed in the 64 bucket
    active = [i for i, sl in enumerate(eng.slots) if sl is not None]
    plan = eng._plan_step(active)
    assert plan.key[2] == 64 and plan.chunks == {2: (0, 64), 3: (0, 40)}
    assert [w[1] is None for w in plan.where] == [False, False, True, False]
    body = functools.partial(eng._step_body, tuple(plan.order))
    want = _leaves_on_host(body(*step_graph.to_device(plan.arrays, dev)))
    eng.graphs.capture(plan.key, body, plan.arrays, dev)
    got = _leaves_on_host(eng.graphs.replay(plan.key, plan.arrays))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_cow_copy_bitwise_on_card_pools(dev):
    """Copy-on-write on the card: a rewind into a block the trie shares
    copies it first; the copy is the source's K and V bits in every
    layer, the source keeps its own, and no other block moves."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve.paged_kv import PagedKVStore

    st = PagedKVStore(smoke_config(get_config("qwen3-0.6b")), n_slots=4,
                      max_len=32, device=dev, block_size=4)
    gen = torch.Generator(device=dev).manual_seed(12)
    for p in st.pools.values():
        p.copy_(torch.randn(p.shape, generator=gen, device=dev))
    before = {k: p.clone() for k, p in st.pools.items()}
    st.slot_blocks[0] = st.allocator.alloc(2)
    pub = list(st.slot_blocks[0])
    toks = np.arange(8, dtype=np.int32)
    st.release(0, publish_tokens=toks)
    assert st.adopt_prefix(1, np.concatenate([toks, [5, 6, 7]])) == 8
    st.rewind(1, 6)
    torch.cuda.synchronize()
    new = st.slot_blocks[1][1]
    assert new != pub[1] and st.cow_copies == 1
    for k, pool in st.pools.items():
        assert torch.equal(pool[:, new], before[k][:, pub[1]]), k
        rest = [b for b in range(pool.shape[1]) if b != new]
        assert torch.equal(pool[:, rest], before[k][:, rest]), k


# ---------------------------------------------------------------------------
# starcoder2-7b's shapes: 36 query heads over 4 KV heads (g 9), head dim
# 128, d 4,608 and an untied (V, D) = (49,152, 4,608) head
# ---------------------------------------------------------------------------
SC2_HQ, SC2_HKV, SC2_D, SC2_V = 36, 4, 4608, 49152


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 64])
def test_paged_attention_starcoder2_shapes(dev, dtype, t):
    """B 8 rows of 1 to 1,024 positions at T 1 (a decode step) and T 64
    (a chunk step), g 9."""
    q, kp, vp, bt, pos = _paged(dev, dtype, b=8, t=t, hq=SC2_HQ, hkv=SC2_HKV,
                                hd=128, bs=16, seed=9 + t,
                                last=[0, 63, 64, 200, 511, 700, 1000, 1023])
    before = pa.paged_attention.launches
    out = pa.paged_attention(q, kp, vp, bt, pos)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    want = ref.paged_attention(q, kp, vp, bt, pos)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_starcoder2_prompt(dev, dtype):
    """A 512-token prompt at g 9, causal."""
    q, k, v = _flash_operands(dev, dtype, b=1, hq=SC2_HQ, hkv=SC2_HKV, t=512,
                              s=512, hd=128, seed=95)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=True)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_on_the_untied_starcoder2_layout(dev, dtype):
    """The argmax head at B 8 and the top-k head at B 4, k 8 on an untied
    head stored as ``weights.cast_params`` stores it (the ``.T`` view of
    a row-major (V, D) tensor), against their plain versions; the verify
    head at B 8, T 8 exact on integer-valued operands."""
    gen = torch.Generator(device=dev).manual_seed(7)
    emb = (torch.randn((SC2_V, SC2_D), generator=gen, device=dev)
           / SC2_D ** 0.5).to(dtype)
    h = torch.randn((8, SC2_D), generator=gen, device=dev).to(dtype)
    _head_check(h, emb)
    _topk_check(h[:4].contiguous(), emb, 8)
    ei = torch.randint(-2, 3, (SC2_V, SC2_D), generator=gen,
                       device=dev).to(dtype)
    hi = torch.randint(-1, 2, (8, 8, SC2_D), generator=gen,
                       device=dev).to(dtype)
    cand = torch.full((8, 7), -1, dtype=torch.int32, device=dev)
    rids, _ = ref.verify_draft(hi, ei.t(), cand)
    cand[:, :4] = rids[:, :4]
    ids, acc = fah.fused_verify_head(hi, ei.t(), cand)
    torch.cuda.synchronize()
    rids, racc = ref.verify_draft(hi, ei.t(), cand)
    assert torch.equal(ids, rids) and torch.equal(acc, racc)
    assert bool((acc >= 4).all())


@pytest.mark.parametrize("kw", [dict(kv_layout="dense"),
                                dict(scheduler="cohort"),
                                dict(kv_layout="dense", host_stride=4)])
def test_dense_and_cohort_graphed_equal_eager(dev, kw):
    """The dense layout and the cohort scheduler on the card: graphed
    (each bucket captured and replayed) the tokens of the same engine
    under ``eager_steps()``, and the dense layout launches no paged
    attention kernel while its heads still launch."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve import step_graph
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config("qwen3-0.6b"))
    params = seeded_params(cfg, 8, dev)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (3, 19, 33, 8)]
    sp = [SamplingParams(max_new_tokens=12),
          SamplingParams(max_new_tokens=12, top_k=4, seed=1),
          SamplingParams(max_new_tokens=12, head_mode="temperature", seed=2),
          SamplingParams(max_new_tokens=12)]
    engine = dict(n_slots=4, max_len=96, **kw)
    with step_graph.eager_steps():
        want = LLM(params, cfg, **engine).generate(prompts, sp)
    paged0 = pa.paged_attention.launches
    heads0 = fah.fused_argmax_head_with_value.launches
    llm = LLM(params, cfg, **engine)
    got = llm.generate(prompts, sp)
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert llm.engine.graphs.replays > 0
    assert fah.fused_argmax_head_with_value.launches > heads0
    if kw.get("kv_layout") == "dense":
        assert pa.paged_attention.launches == paged0
    else:
        assert llm.stats["decode_steps"] > llm.stats["iterations"]


def test_lm_forward_on_card_matches_cpu(dev):
    """``lm.forward`` (the eval forward, flash attention over every
    position) on the card against the plain versions on the CPU, f32, on
    starcoder2-7b's smoke config (gelu MLP, untied head)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import lm
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config("starcoder2-7b"))
    cpu = seeded_params(cfg, 4, "cpu")
    gpu = _to_device(cpu, dev)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, 37)))
    before = fa.flash_attention.launches
    got, _ = lm.forward(gpu, cfg, toks.to(dev))
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + cfg.n_layers
    want, _ = lm.forward(cpu, cfg, toks)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def test_graphed_hybrid_engine_equals_eager_and_the_cpu(dev):
    """recurrentgemma-2b's smoke config (3 layers (rec, rec, attn),
    window 16, f32, seeded weights): the T = 1 hybrid step captured per
    bucket on the card -- ring buffers and recurrent state written in
    place inside the graph -- gives the eager step's tokens on the card
    and the plain versions' on the CPU, with no paged-attention launch;
    five prompts of 4-19 tokens on 4 slots (a bucket pads 3 rows to 4),
    12 new tokens each (decode past positions 16 and 32)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve import step_graph
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config("recurrentgemma-2b"))
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (4, 11, 19, 7, 15)]

    def serve(device):
        eng = ServeEngine(seeded_params(cfg, 0, device), cfg, n_slots=4,
                          max_len=40, eos_id=-1)
        reqs = [Request(i, p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [list(r.generated) for r in reqs], eng

    want, _ = serve("cpu")
    with step_graph.eager_steps():
        eager, _ = serve(dev)
    pa.paged_attention.launches = 0
    graphed, eng = serve(dev)
    assert eager == graphed == want
    assert eng.graphs.replays > 0 and not eng.store.any_paged
    assert pa.paged_attention.launches == 0


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "llama4-maverick-400b-a17b"])
def test_graphed_moe_engine_equals_eager_and_the_cpu(dev, arch):
    """The MoE family's smoke configs (phi3.5-moe: top-2 every layer;
    llama4-maverick: (attn, moe) with a shared expert; f32, seeded
    weights) at capacity factor 0.5, so choices drop: the T = 1 step with
    its scatter executor captured per bucket on the card (routing, ranks
    and the spare row inside the graph) gives the eager step's tokens on
    the card and the plain versions' on the CPU; five prompts of 4-19
    tokens on 4 slots (a bucket pads 3 rows to 4), 12 new tokens each;
    paged attention once a layer a decode step."""
    import dataclasses

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve import step_graph
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.weights import seeded_params

    cfg = smoke_config(get_config(arch))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (4, 11, 19, 7, 15)]

    def serve(device):
        eng = ServeEngine(seeded_params(cfg, 0, device), cfg, n_slots=4,
                          max_len=40, eos_id=-1)
        reqs = [Request(i, p, max_new_tokens=12)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [list(r.generated) for r in reqs], eng

    want, _ = serve("cpu")
    with step_graph.eager_steps():
        eager, _ = serve(dev)
    pa.paged_attention.launches = 0
    graphed, eng = serve(dev)
    assert eager == graphed == want
    assert eng.graphs.replays > 0 and eng.store.any_paged
    assert pa.paged_attention.launches \
        == cfg.n_layers * eng.stats["decode_steps"]
