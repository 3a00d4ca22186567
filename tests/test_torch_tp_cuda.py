"""The vocabulary-sharded heads on the card (marker ``cuda``; skips where
CUDA is absent, as ``tests/test_torch_cuda.py`` does).

The verify head's optional value output, and the merges of
``core.reduced_softmax`` over slices the kernels ran one at a time: the
unsharded kernels' ids and values bit for bit, a vocabulary split into
2, 4 and 8 contiguous slices, the last ones not multiples of the 64-id
tile.  ``chip_smoke.py`` phase 4k runs the same at qwen3's full
vocabulary and the tensor-parallel engine across processes.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import reduced_softmax as rs  # noqa: E402
from repro_torch.kernels import fused_argmax_head as fah  # noqa: E402
from repro_torch.kernels import fused_topk_head as ftk  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _head(dev, dtype, v=9_000, d=256, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    emb = (torch.randn((v, d), generator=gen, device=dev)
           / math.sqrt(d)).to(dtype)
    h = torch.randn((8, 8, d), generator=gen, device=dev).to(dtype)
    return emb, h


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_verify_head_values_are_the_argmax_heads(dev, dtype):
    emb, h = _head(dev, dtype)
    cand = torch.full((8, 7), -1, dtype=torch.int32, device=dev)
    ids, acc, vals = fah.fused_verify_head(h, emb.t(), cand,
                                           with_value=True)
    ids2, acc2 = fah.fused_verify_head(h, emb.t(), cand)
    idx, val = fah.fused_argmax_head_with_value(h.reshape(64, -1), emb.t())
    assert torch.equal(ids, ids2) and torch.equal(acc, acc2)
    assert torch.equal(ids.reshape(64), idx)
    assert torch.equal(vals.reshape(64), val)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_merged_slices_equal_the_unsharded_kernels(dev, dtype, n):
    v = 9_000 - 9_000 % n          # slices of 4,496, 2,248, 1,124 ids
    emb, h = _head(dev, dtype, v=v)
    w, h8, h4 = emb.t(), h[:, 0].contiguous(), h[:4, 0].contiguous()
    idx, val = fah.fused_argmax_head_with_value(h8, w)
    tvals, tids = ftk.fused_topk_head(h4, w, 8)
    ids0, _ = fah.fused_verify_head(h, w, torch.full(
        (8, 7), -1, dtype=torch.int32, device=dev))
    cand = ids0[:, :7].contiguous()
    cand[2, 3] = (cand[2, 3] + 1) % v
    vids, vacc = fah.fused_verify_head(h, w, cand)
    per = v // n
    a, k, t = [], [], []
    for r in range(n):
        ws = emb[r * per:(r + 1) * per].contiguous().t()
        a.append(rs.shard_argmax_table(h8, ws, r * per))
        k.append(rs.shard_topk_table(h4, ws, 8, v_lo=r * per, rank=r,
                                     ranks=n, vocab_size=v))
        t.append(rs.shard_verify_table(h, ws, cand, r * per))
    m_idx, m_val = rs.merge_argmax(torch.stack([x[0] for x in a]),
                                   torch.stack([x[1] for x in a]))
    m_vals, m_ids = rs.merge_topk(torch.stack([x[0] for x in k]),
                                  torch.stack([x[1] for x in k]), 8)
    m_vid, _ = rs.merge_argmax(torch.stack([x[0] for x in t]),
                               torch.stack([x[1] for x in t]))
    assert torch.equal(m_idx, idx) and torch.equal(m_val, val)
    assert torch.equal(m_ids, tids) and torch.equal(m_vals, tvals)
    assert torch.equal(m_vid, vids)
    assert torch.equal(rs.accepted_run(m_vid, cand), vacc)
