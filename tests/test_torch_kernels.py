"""The port's kernel entry points (``repro_torch.kernels.ops``) on the CPU
against the JAX package: its Pallas kernels in interpret mode and its
jnp oracles (``repro.kernels.ref``), on the same numpy inputs.

On the CPU the entries run their plain PyTorch versions; the CUDA
kernels are held against those same plain versions on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_argmax_head import (  # noqa: E402
    fused_argmax_head_with_value as pallas_argmax,
)
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import fused_argmax_head as tfah  # noqa: E402
from repro_torch.kernels import fused_xent as tfx  # noqa: E402
from repro_torch.kernels import online_softmax as tos  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.serve.paged_kv import pow2  # noqa: E402

torch.set_num_threads(2)

# f32 end to end: the two frameworks differ only in summation order
ATOL = RTOL = 1e-5


def _paged_case(seed, *, t, g, hkv=2, hd=16, bs=4, b=3):
    """Random pools, ragged per-row positions, PERMUTED block ids and a
    table padded to a power of two with each row's own first block --
    the engine's layout."""
    rng = np.random.default_rng(seed)
    last = np.array([2, 9, 22])[:b]                  # each row's last query
    if t == 1:
        pos = last.astype(np.int32)                  # (B,)
    else:
        # consecutive windows ending at `last`; row 0 is narrower and
        # repeats its last position (the engine's padding rule)
        pos = np.stack([np.maximum(np.arange(p - t + 1, p + 1), 0)
                        for p in last]).astype(np.int32)
        pos[0, :] = np.minimum(pos[0], pos[0, -2])
    nbs = last // bs + 1
    nb = pow2(int(nbs.max()))
    nblocks = int(nbs.sum()) + 3
    perm = rng.permutation(nblocks)
    table, k0 = [], 0
    for n in nbs:
        own = list(perm[k0:k0 + n])
        k0 += n
        table.append(own + [own[0]] * (nb - n))
    hq = g * hkv
    qshape = (b, hq, hd) if t == 1 else (b, t, hq, hd)
    q = rng.normal(size=qshape).astype(np.float32)
    kp = rng.normal(size=(nblocks, bs, hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(nblocks, bs, hkv, hd)).astype(np.float32)
    return q, kp, vp, np.asarray(table, np.int32), pos


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("t", [1, 4])
def test_paged_attention_matches_pallas_and_ref(t, g, window):
    q, kp, vp, bt, pos = _paged_case(10 * t + g, t=t, g=g)
    want_pallas = np.asarray(jops.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), use_pallas=True, interpret=True, window=window))
    want_ref = np.asarray(jref.paged_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(pos), window=window))
    got = tops.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(bt), torch.from_numpy(pos), window=window).numpy()
    assert got.shape == q.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t,g", [(32, 2), (16, 4)])
def test_paged_attention_wide_windows_match_pallas_and_ref(t, g):
    """T * g = 64 query rows per (row, KV head): a speculative window of
    spec_k >= 16 at g = 2, or a narrower one at g = 4 -- more rows than
    one 32-warp thread block of the CUDA kernel holds."""
    q, kp, vp, bt, pos = _paged_case(t + g, t=t, g=g)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, bt, pos)]
    want_pallas = np.asarray(jops.paged_attention(
        *jargs, use_pallas=True, interpret=True))
    want_ref = np.asarray(jref.paged_attention(*jargs))
    got = tops.paged_attention(
        *[torch.from_numpy(a) for a in (q, kp, vp, bt, pos)]).numpy()
    assert got.shape == q.shape
    np.testing.assert_allclose(got, want_pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)


def test_paged_attention_ignores_table_padding():
    """Padded table columns sit past each row's position: rewriting them
    to other (foreign) blocks changes nothing."""
    q, kp, vp, bt, pos = _paged_case(3, t=1, g=2)
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    base = tops.paged_attention(*args, torch.from_numpy(bt),
                                torch.from_numpy(pos))
    bt2 = bt.copy()
    nbs = pos // kp.shape[1] + 1
    for r, n in enumerate(nbs):
        bt2[r, n:] = (bt2[r, n:] + 1) % kp.shape[0]
    moved = tops.paged_attention(*args, torch.from_numpy(bt2),
                                 torch.from_numpy(pos))
    assert torch.equal(base, moved)


def _head_case(seed, b, d, v, ties=False):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, d)).astype(np.float32)
    w = rng.normal(size=(d, v)).astype(np.float32)
    if ties:
        # equal maximal columns in two different 512-wide vocab tiles
        h = np.abs(h)
        w = np.full((d, v), -1.0, np.float32)
        w[:, 100] = w[:, 700] = 1.0
    return h, w


@pytest.mark.parametrize("b,d,v,ties", [(2, 8, 1000, True),
                                        (1, 64, 1000, False),
                                        (8, 64, 1000, False),
                                        (5, 48, 777, False)])
def test_argmax_head_matches_pallas_and_ref(b, d, v, ties):
    h, w = _head_case(b * v + d, b, d, v, ties)
    p_idx, p_val = pallas_argmax(jnp.asarray(h), jnp.asarray(w),
                                 interpret=True)
    r_idx, r_val = jref.fused_argmax_head_with_value(jnp.asarray(h),
                                                     jnp.asarray(w))
    idx, val = tops.fused_argmax_head_with_value(torch.from_numpy(h),
                                                 torch.from_numpy(w))
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(p_idx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(val.numpy(), np.asarray(r_val),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(
        tops.fused_argmax_head(torch.from_numpy(h),
                               torch.from_numpy(w)).numpy(), idx.numpy())
    if ties:
        assert np.all(idx.numpy() == 100)


def test_cpu_dispatch_never_launches_and_kernels_refuse_cpu():
    """CPU tensors take the plain versions: the launch counters stay 0.
    The CUDA wrappers themselves refuse CPU tensors -- no silent CPU
    run -- and unknown attention modes raise."""
    counted = (tpa.paged_attention, tfah.fused_argmax_head_with_value,
               tfa.flash_attention, tos.softmax_stats, tos.online_softmax,
               tfx.fused_xent)
    for fn in counted:
        fn.launches = 0
    q, kp, vp, bt, pos = (torch.from_numpy(a)
                          for a in _paged_case(5, t=1, g=2))
    tops.paged_attention(q, kp, vp, bt, pos)
    tops.paged_attention(q, kp, vp, bt, pos, attn_approx="maxonly")
    h, w = (torch.from_numpy(a) for a in _head_case(0, 2, 16, 300))
    tops.fused_argmax_head_with_value(h, w)
    fq = torch.randn(1, 4, 6, 16)
    fk = torch.randn(1, 2, 6, 16)
    tops.flash_attention(fq, fk, fk)
    x = (h @ w).requires_grad_(True)
    lab = torch.tensor([3, 7])
    tops.softmax_stats(x)
    tops.online_softmax(x)
    tops.softmax_xent(x, lab).sum().backward()
    assert all(fn.launches == 0 for fn in counted)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.paged_attention(q, kp, vp, bt, pos)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfah.fused_argmax_head_with_value(h, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention(fq, fk, fk)
    for fn in (tos.softmax_stats, tos.online_softmax):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x.detach())
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfx.fused_xent(x.detach(), lab)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tpa.paged_attention(q, kp, vp, bt, pos, attn_approx="maxonly")
    with pytest.raises(ValueError):
        tops.paged_attention(q, kp, vp, bt, pos, attn_approx="nope")
