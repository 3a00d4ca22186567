"""Head dims and row counts the port's kernels take, on the CPU against
the JAX package.

Head dim 192 (nemotron-4-340b's): the port's plain paged attention and
flash attention against the Pallas kernels in interpret mode and the jnp
oracles, on the same seeded numpy inputs at smoke widths, in f32 (the
frameworks differ in summation order only: 1e-5 for paged attention,
2e-5 for flash attention, as in ``test_torch_kernels.py`` and
``test_torch_prefill.py``).  Every head dim of ``repro_torch.configs``
is one both CUDA wrappers take.  The CUDA kernels themselves at hd 192
and at 70,000 softmax rows are held against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.serve.paged_kv import pow2  # noqa: E402

torch.set_num_threads(2)

PAGED_TOL = 1e-5
FLASH_TOL = 2e-5
HD = 192


def _paged_case(seed, *, t, g, hkv=2, bs=4):
    """Ragged rows (last positions 2, 9, 22), permuted pool blocks, tables
    padded to a power of two with each row's own first block."""
    rng = np.random.default_rng(seed)
    last = np.array([2, 9, 22])
    pos = last.astype(np.int32) if t == 1 else np.maximum(
        last[:, None] - np.arange(t - 1, -1, -1), 0).astype(np.int32)
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
    qshape = (3, hq, HD) if t == 1 else (3, t, hq, HD)
    q = rng.normal(size=qshape).astype(np.float32)
    kp = rng.normal(size=(nblocks, bs, hkv, HD)).astype(np.float32)
    vp = rng.normal(size=(nblocks, bs, hkv, HD)).astype(np.float32)
    return q, kp, vp, np.asarray(table, np.int32), pos


@pytest.mark.parametrize("mode", ["exact", "pseudo", "maxonly"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("t,g", [(1, 2), (4, 6)])
def test_paged_attention_hd192_matches_pallas_and_ref(t, g, window, mode):
    args = _paged_case(t * g + (window or 0), t=t, g=g)
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jops.paged_attention(
        *jargs, use_pallas=True, interpret=True, window=window,
        attn_approx=mode))
    want = np.asarray(jref.paged_attention(*jargs, window=window,
                                           attn_approx=mode))
    got = tops.paged_attention(*(torch.from_numpy(a) for a in args),
                               window=window, attn_approx=mode).numpy()
    assert got.shape == args[0].shape and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, atol=PAGED_TOL, rtol=PAGED_TOL)
    np.testing.assert_allclose(got, want, atol=PAGED_TOL, rtol=PAGED_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 16)])
@pytest.mark.parametrize("hq,hkv,t", [(4, 2, 64), (6, 1, 37)])
def test_flash_attention_hd192_matches_pallas_and_oracle(hq, hkv, t,
                                                         causal, window):
    rng = np.random.default_rng(t + hq)
    q = rng.standard_normal((1, hq, t, HD), np.float32)
    k = rng.standard_normal((1, hkv, t, HD), np.float32)
    v = rng.standard_normal((1, hkv, t, HD), np.float32)
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal,
                               window=window).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pal = np.asarray(pallas_flash(jq, jk, jv, causal=causal, window=window,
                                  interpret=True, block_t=32, block_s=128))
    want = np.asarray(jref.flash_attention(jq, jk, jv, causal=causal,
                                           window=window))
    assert got.shape == q.shape
    np.testing.assert_allclose(got, pal, atol=FLASH_TOL, rtol=FLASH_TOL)
    np.testing.assert_allclose(got, want, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_head_dim_is_a_kernel_head_dim(arch):
    """Both attention wrappers, and the paged kernel's chunk plan, take
    every head dim the port's configs name."""
    hd = ARCHS[arch].head_dim
    assert hd in tpa._HEAD_DIMS and hd in tfa._HEAD_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        assert tpa.chunk_width(dtype, hd) % tpa.CHUNK_QUANTUM == 0
