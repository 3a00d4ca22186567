"""The CUDA argmax and verify heads' vocabulary split, modelled on the
CPU: ``repro_torch.kernels.ref.argmax_head_split`` runs the kernels' two
passes -- a (max, first index) partial per (row group, vocabulary range),
then a merge in range order by "larger value, else lower index" -- under
the plan ``fused_argmax_head.head_plan`` gives, and must equal the JAX
package's Pallas kernels in interpret mode (``fused_argmax_head`` and
``fused_verify_head``) exactly on integer-valued operands, whose sums are
exact in any order: ties planted in far ranges, vocabularies that are
not a multiple of the tile, trailing ranges with no id, all-negative
logits (an unmasked zero-filled tail would win), 1 to 256 rows.

The plans are pure functions of shapes and of the card's SM count and
shared memory, checked here for the H100: the argmax and verify entries
get the same plan at equal row counts; the tensor-core plan follows the
row count only through its 64-row groups; every config's width fits in
shared memory; the CUDA-core routes' rows per block never exceed it.
The kernels themselves are held against the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_argmax_head import (  # noqa: E402
    fused_argmax_head_with_value as pallas_argmax,
)
from repro.kernels.fused_topk_head import (  # noqa: E402
    fused_verify_head as pallas_verify,
)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import fused_argmax_head as fah  # noqa: E402
from repro_torch.kernels import fused_topk_head as ftk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

torch.set_num_threads(2)

H100_SMEM = 232448       # opt-in shared memory per block, bytes
DTYPES = (torch.bfloat16, torch.float32)


def _operands(seed, r, d, v, *, negative=False, ties=True):
    """Integer-valued h (r, d) and w (d, v): exact sums.  ``ties`` copies
    each row's winning column half the vocabulary away, so equal maxima
    sit in far ranges; ``negative`` makes every logit negative."""
    rng = np.random.default_rng(seed)
    if negative:
        h = rng.integers(1, 3, size=(r, d)).astype(np.float32)
        w = rng.integers(-3, 0, size=(d, v)).astype(np.float32)
    else:
        h = rng.integers(-1, 2, size=(r, d)).astype(np.float32)
        w = rng.integers(-2, 3, size=(d, v)).astype(np.float32)
    if ties:
        for a in np.argmax(h @ w, axis=-1):
            w[:, (a + v // 2) % v] = w[:, a]
    return h, w


def _twin(h, w, plan):
    idx, val = ref.argmax_head_split(torch.from_numpy(h),
                                     torch.from_numpy(w), plan)
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    return idx.numpy(), val.numpy()


def _assert_pallas(h, w, plan):
    p_idx, p_val = pallas_argmax(jnp.asarray(h), jnp.asarray(w),
                                 interpret=True)
    idx, val = _twin(h, w, plan)
    np.testing.assert_array_equal(idx, np.asarray(p_idx))
    np.testing.assert_array_equal(val, np.asarray(p_val))
    return idx


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,v", [(1, 777), (8, 777), (64, 3000),
                                 (65, 3000), (256, 777), (1, 151936),
                                 (8, 151936), (65, 151936)])
def test_split_twin_matches_pallas_argmax(dtype, r, v):
    """Planted far ties, V a multiple of neither the kernel's 128-id tile
    (777, 3000) nor the Pallas kernel's 512-wide block (151936)."""
    h, w = _operands(r * 7 + v, r, 64, v)
    plan = fah.head_plan((r, 64), v, dtype)
    idx = _assert_pallas(h, w, plan)
    logits = h @ w
    assert all(logits[i, idx[i]] == logits[i].max() for i in range(r))
    # the lower of each planted pair won wherever the pair still leads
    for i in range(r):
        tied = np.flatnonzero(logits[i] == logits[i].max())
        assert idx[i] == tied[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r", [1, 8, 65])
def test_split_twin_masks_the_tail_on_negative_logits(dtype, r):
    """Every logit negative and V = 777 (13 tiles, the last 55 ids short):
    the tail's zero-filled columns must read -inf, or 0 would win."""
    h, w = _operands(r, r, 32, 777, negative=True)
    assert (h @ w).max() < 0
    plan = fah.head_plan((r, 32), 777, dtype)
    assert plan.nsplit * plan.split_ids > 777
    idx = _assert_pallas(h, w, plan)
    assert (idx < 777).all()


@pytest.mark.parametrize("extra", [1, 3])
def test_split_twin_trailing_ranges_with_no_id(extra):
    """More ranges than the vocabulary fills: the trailing ones hold no
    id, give (-inf, -1), and lose every merge -- as in the f32 split at V
    49152 (528 ranges of 94 ids)."""
    h, w = _operands(extra, 8, 32, 777, negative=True)
    plan = fah.head_plan((8, 32), 777, torch.bfloat16, sm_count=4)
    plan = dataclasses.replace(plan, nsplit=plan.nsplit + extra)
    assert (plan.nsplit - 1) * plan.split_ids >= 777
    _assert_pallas(h, w, plan)
    f32 = fah.head_plan((8, 32), 49152, torch.float32)
    assert (f32.nsplit - 1) * f32.split_ids >= 49152
    h, w = _operands(extra, 8, 32, 49152, negative=True)
    _assert_pallas(h, w, f32)


@pytest.mark.parametrize("b,t", [(8, 1), (8, 8), (1, 32), (8, 32)])
def test_split_twin_matches_pallas_verify(b, t):
    """The verify head: the twin's ids over the B*T position rows and the
    leading run of ids == drafts equal the Pallas verify head's exactly;
    drafts are a prefix of each row's ids of ragged width, some with a
    wrong token inside."""
    v, d = 1100, 32
    h, w = _operands(b * t, b * t, d, v)
    plan = fah.head_plan((b, t, d), v, torch.bfloat16)
    ids = _twin(h, w, plan)[0].reshape(b, t)
    rng = np.random.default_rng(t)
    cand = np.full((b, t - 1), -1, np.int32)
    for r in range(b):
        width = int(rng.integers(0, t))
        cand[r, :width] = ids[r, :width]
        if width and r % 3 == 0:
            j = int(rng.integers(0, width))
            cand[r, j] = (cand[r, j] + 1) % v
    accept = np.cumprod(ids[:, :t - 1] == cand, axis=-1).sum(-1)
    p_ids, p_acc = pallas_verify(jnp.asarray(h.reshape(b, t, d)),
                                 jnp.asarray(w), jnp.asarray(cand),
                                 interpret=True)
    np.testing.assert_array_equal(ids, np.asarray(p_ids))
    np.testing.assert_array_equal(accept, np.asarray(p_acc))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,v", [(1024, 151936), (18432, 256000)])
def test_plan_is_the_same_for_argmax_and_verify_at_equal_rows(dtype, d, v):
    for rows, shapes in ((8, [(8, 1), (1, 8), (2, 4)]),
                         (64, [(8, 8), (2, 32), (64, 1)]),
                         (256, [(8, 32), (32, 8)])):
        want = fah.head_plan((rows, d), v, dtype)
        for b, t in shapes:
            assert fah.head_plan((b, t, d), v, dtype) == want


@pytest.mark.parametrize("d,v", [(1024, 151936), (18432, 256000),
                                 (64, 777)])
def test_mma_plan_follows_rows_only_through_row_groups(d, v):
    """Every field but the group count is the same at every B and T, and
    the groups are ceil(B*T / 64): the ranges never follow B or T."""
    base = fah.head_plan((1, d), v, torch.bfloat16)
    assert base.route == "wgmma" and base.row_block == fah.ROW_GROUP
    for b in (1, 2, 7, 8, 13, 64):
        for t in (1, 2, 5, 8, 21, 32):
            plan = fah.head_plan((b, t, d), v, torch.bfloat16)
            assert plan.row_blocks == -(-b * t // 64)
            assert dataclasses.replace(plan, row_blocks=1) == base


def test_vocab_151936_divides_into_whole_tiles_on_132_sms():
    """2374 tiles of 64 ids: 131 ranges of 18 tiles and one of 16, one
    block per SM."""
    plan = fah.head_plan((8, 1024), 151936, torch.bfloat16)
    assert 151936 == 2374 * fah.VOCAB_TILE
    assert (plan.nsplit, plan.split_ids) == (132, 18 * fah.VOCAB_TILE)
    assert 151936 - (plan.nsplit - 1) * plan.split_ids == 16 * 64


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_config_width_fits_in_shared_memory(arch):
    """Each config's d_model and vocabulary: both routes of the argmax
    and verify heads and the top-k head fit the H100's 227 KB; the
    tensor-core ranges are whole tiles that cover V, one per SM at most,
    none empty (the f32 split's last ranges may be: 528 ranges of 94 ids
    leave the last four empty at V 49152)."""
    cfg = ARCHS[arch]
    d, v = cfg.d_model, cfg.vocab_size
    for rows in (1, 8, 64, 256):
        for dtype in DTYPES:
            plan = fah.head_plan((rows, d), v, dtype)
            assert plan.smem_bytes + fah.STATIC_SMEM <= H100_SMEM
            assert plan.nsplit * plan.split_ids >= v
            assert plan.row_blocks * plan.row_block >= rows
            if dtype == torch.bfloat16:
                assert (plan.nsplit - 1) * plan.split_ids < v
                assert plan.split_ids % fah.VOCAB_TILE == 0
                assert plan.nsplit <= fah.H100_SMS
            tk = ftk.topk_plan(rows, d, v, dtype)
            assert tk.smem_bytes + fah.STATIC_SMEM <= H100_SMEM


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [64, 1024, 5120, 6144, 18432])
def test_cuda_core_row_block_stays_within_the_budget(dtype, d):
    """BT of the f32 argmax route and of the top-k head: the largest of
    {8, 4, 2, 1} up to B within the shared memory (less 2 KB for the
    kernels' static shared memory), never above it."""
    esize = torch.finfo(dtype).bits // 8
    for b in (1, 2, 3, 4, 7, 8, 13):
        tk = ftk.topk_plan(b, d, 256000, dtype)
        checks = [(tk, lambda bt: fah.staged_bytes(d, bt, esize)
                   + bt * tk.split_ids * 4)]
        if dtype == torch.float32:
            checks.append((fah.head_plan((b, d), 256000, dtype),
                           lambda bt: fah.staged_bytes(d, bt, 4)))
        for plan, smem in checks:
            budget = H100_SMEM - fah.STATIC_SMEM
            assert plan.smem_bytes == smem(plan.row_block) <= budget
            assert plan.row_block <= b
            assert plan.row_blocks == -(-b // plan.row_block)
            assert all(smem(bt) > budget for bt in fah.ROW_BLOCKS
                       if plan.row_block < bt <= b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_block_is_2_at_d_18432(dtype):
    """nemotron-4-340b's width: two rows of h fit beside the top-k
    logits, four do not; B 8 then takes four row chunks."""
    tk = ftk.topk_plan(8, 18432, 256000, dtype)
    assert (tk.row_block, tk.row_blocks) == (2, 4)
    if dtype == torch.float32:
        plan = fah.head_plan((8, 18432), 256000, dtype)
        assert (plan.row_block, plan.row_blocks) == (2, 4)
    assert ftk.topk_plan(8, 1024, 151936, dtype).row_block == 8
