"""The port's training path on the card: the gradient of ``train_loss``
through the CUDA kernels against the plain path on the CPU, and the
guard of the ``ops`` entries whose kernels have no backward.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; run them on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_cuda.py

Tolerances (f32, TF32 off): the loss within 1e-4, each gradient leaf
within 1e-3 of its largest |value| (the card's kernels and GEMMs sum in
other orders than the CPU's plain versions; a missing gradient is off
by all of it); flash attention's gradient within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as tree_mod  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402

pytestmark = pytest.mark.cuda

SERVED = ("qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-2b",
          "rwkv6-7b")


def _tokens(vocab, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (b, s + 1)).astype(np.int32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("arch", SERVED)
def test_card_gradients_match_the_cpu(arch, dev):
    """``train_loss`` and every gradient leaf on the card (the flash
    kernel forward, the cross-entropy kernel, the head GEMM's backward)
    against the CPU's plain path, f32: loss within 1e-4, each leaf
    within 1e-3 of its largest |value|, none missing."""
    cfg = smoke_config(get_config(arch))
    params = weights.seeded_params(cfg, 0, "cpu")
    toks = torch.from_numpy(_tokens(cfg.vocab_size, s=64, seed=6))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want_loss, want = steps_mod.loss_and_grads(params, cfg, batch)
    on = tree_mod.map_tree(lambda _, t: t.to(dev), params)
    got_loss, got = steps_mod.loss_and_grads(
        on, cfg, {k: v.to(dev) for k, v in batch.items()})
    assert abs(float(got_loss) - float(want_loss)) <= 1e-4
    for (p, a), (_, b) in zip(tree_mod.items(want), tree_mod.items(got)):
        scale = float(a.abs().max())
        assert scale == 0 or float(b.abs().max()) > 0, tree_mod.key(p)
        assert float((b.cpu() - a).abs().max()) <= 1e-3 * max(scale, 1e-3), \
            tree_mod.key(p)


def test_card_kernels_without_a_backward_raise(dev):
    """On the card, each entry of ``ops`` without a backward refuses an
    operand that requires grad; flash attention carries it."""
    x = torch.randn(4, 64, device=dev, requires_grad=True)
    for fn in (ops.softmax_stats, ops.online_softmax):
        with pytest.raises(ValueError, match="no backward"):
            fn(x)
    w = torch.randn(64, 256, device=dev)
    with pytest.raises(ValueError, match="no backward"):
        ops.fused_argmax_head_with_value(x, w)
    with pytest.raises(ValueError, match="no backward"):
        ops.fused_topk_head(x, w, 4)
    q = torch.randn(1, 2, 8, 16, device=dev, requires_grad=True)
    kv = torch.randn(1, 2, 8, 16, device=dev)
    out = ops.flash_attention(q, kv, kv)
    (gq,) = torch.autograd.grad(out.sum(), q)
    qc = q.detach().cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(ref.flash_attention(
        qc, kv.cpu(), kv.cpu()).sum(), qc)
    torch.testing.assert_close(gq.cpu(), want, rtol=1e-4, atol=1e-4)


class _Loopback:
    """A group of one rank on the card (the slice is the whole of what
    this process holds): ``all_gather`` stacks, ``all_reduce_sum`` keeps
    -- enough to run the vocabulary-parallel loss's kernels on one
    slice."""

    world, rank = 1, 0

    def __init__(self):
        self.bytes = {}

    def all_gather(self, x, kind):
        return x[None].clone()

    def all_reduce_sum(self, x, kind):
        return x


@pytest.mark.parametrize("v", [75968, 37984])
def test_vocab_parallel_loss_kernels_match_their_plain_composition(v, dev):
    """The vocabulary-parallel loss on a (4,096, V / M) f32 slice at M 2
    and 4 of qwen3's vocabulary (``api.vocab_parallel_xent``: the stats
    kernel forward, the softmax kernel times ``l_r exp(m_r - lse)``
    backward), half its labels outside the slice, against the plain
    composition on the card: ``logsumexp(x) - x[label]`` (0 where the
    label lies elsewhere) within 1e-5, and ``(exp(x - lse) - onehot) *
    g`` within 1e-6; and two slices' kernel stats merged
    (``api.merge_stats``) equal the whole row's logsumexp within 1e-5,
    bitwise the same on repeat."""
    from repro_torch.models import api

    gen = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn((4096, v), generator=gen, device=dev) * 4
    lab = torch.randint(0, 2 * v, (4096,), generator=gen, device=dev)
    g = torch.rand((4096,), generator=gen, device=dev)
    xs = x.clone().requires_grad_(True)
    loss = api.vocab_parallel_xent(xs, lab, _Loopback(), 0)
    (grad,) = torch.autograd.grad(loss, xs, g)
    lse = torch.logsumexp(x.double(), -1)
    mine = lab < v
    pick = torch.where(mine, x.double()[torch.arange(4096, device=dev),
                                        lab.clamp(max=v - 1)], 0.0)
    torch.testing.assert_close(loss.double(), lse - pick, rtol=0,
                               atol=1e-5)
    want = torch.exp(x.double() - lse[:, None])
    rows = torch.nonzero(mine).reshape(-1)
    want[rows, lab[rows]] -= 1
    want *= g.double()[:, None]
    torch.testing.assert_close(grad.double(), want, rtol=0, atol=1e-6)
    halves = [x[:, :v // 2].contiguous(), x[:, v // 2:].contiguous()]
    merged = [api.merge_stats(torch.stack([torch.stack(
        ops.softmax_stats(h), 1) for h in halves])) for _ in range(2)]
    assert torch.equal(merged[0], merged[1])
    torch.testing.assert_close(merged[0].double(), lse, rtol=0, atol=1e-5)
