"""The port's CUDA kernels against their plain PyTorch versions, on the
card, across the shapes and dtypes the wrappers take -- beyond the main
path's shapes that ``chip_smoke.py`` checks.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  Run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 kernels sum in another order than the plain versions
(atol = rtol = 1e-4); bf16 paged attention keeps f32 probabilities where
the plain version rounds scores and probabilities to bf16 (2e-2); head
indices must be equal wherever the plain top-2 f32 logit gap exceeds
1e-3 * |max|, and exactly equal on planted ties.  The top-k head's
values agree at rtol 1e-5 (f32) / 1e-3 (bf16); its indices are exact
except where two neighbouring values lie within that rtol, and exact on
integer-valued inputs, whose sums are exact in any order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_argmax_head as fah  # noqa: E402
from repro_torch.kernels import fused_topk_head as ftk  # noqa: E402
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
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
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
@pytest.mark.parametrize("b", [1, 2, 5, 8, 13])
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
@pytest.mark.parametrize("b,t", [(1, 2), (8, 2), (8, 8), (3, 40), (2, 1)])
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


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-32b"])
def test_engine_on_card_matches_cpu(dev, arch):
    """The smoke config served on the card (kernels) gives the CPU's
    tokens (plain versions) from the same weights, and the decode path
    launches each kernel.  qwen3-32b's head is an untied ``lm_head``."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.serve.api import LLM
    from repro_torch.serve.params import SamplingParams
    from repro_torch.weights import init_params

    cfg = smoke_config(get_config(arch))
    cpu = init_params(cfg, torch.Generator().manual_seed(3), "cpu")

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
    llm = LLM(to(cpu, dev), cfg, **kw)
    got = llm.generate(prompts, sp)
    st = llm.stats
    assert [o.token_ids for o in got] == [o.token_ids for o in want]
    assert pa.paged_attention.launches == cfg.n_layers * st["decode_steps"]
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
